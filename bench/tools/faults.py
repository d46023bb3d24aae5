"""Faults planted under a cell's timed path, for the check's readings and
its tests (the benchmark's own runs plant none).

Each fault is a hook that a driver runs at the end of its build, so the
window drives the broken path exactly as it drives the sound one:

  training  ``state_unchanged`` (a step that returns its state as it got
            it), ``half_batch`` (each worker's loss over the first half
            of its batch, the mean over the rest), ``no_merge`` (the bsp
            exchange left out: each copy takes its own worker's
            gradient), ``answer_altered`` (the loss, and so its gradient,
            1% off where it is produced);
  search    ``half_batch`` (the top-k answers the first half of a batch's
            rows, and the rest get those answers again),
            ``answer_altered`` (the nearest row of a batch's first query
            named one row off where the top-k produces it).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.ps import sync


def _train_state_unchanged(drv):
    step = drv.step_fn

    def f(state, batch):
        _, metrics = step(state, batch)
        return state, metrics

    drv.step_fn = f


def _train_half_batch(drv):
    step = drv.step_fn

    def f(state, batch):
        h = next(iter(batch.values())).shape[1] // 2
        return step(state, {k: v[:, :h] for k, v in batch.items()})

    drv.step_fn = f


def _train_no_merge(drv):
    ps = sync.PSConfig(n_workers=drv.P, sync="local", tau=1 << 30,
                       seed=drv.ps_seed)
    drv.step_fn = sync.make_train_step(drv.loss_fn, drv.opt, ps)


def _train_answer_altered(drv):
    loss_fn = drv.loss_fn

    def altered(L, batch):
        loss, aux = loss_fn(L, batch)
        return loss * 1.01, aux

    drv.step_fn = sync.make_train_step(altered, drv.opt, drv.ps)


def _search_half_batch(drv):
    topk = drv.index.topk

    def f(q, k_top, **kw):
        n = q.shape[0]
        h = math.ceil(n / 2)
        d, i = topk(q[:h], k_top, **kw)
        return torch.cat([d, d[:n - h]]), torch.cat([i, i[:n - h]])

    drv.index.topk = f


def _search_answer_altered(drv):
    topk, rows = drv.index.topk, drv.cfg["n_samples"]

    def f(q, k_top, **kw):
        d, i = topk(q, k_top, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % rows
        return d, i

    drv.index.topk = f


FAULTS = {
    "train_ps": {"state_unchanged": _train_state_unchanged,
                 "half_batch": _train_half_batch,
                 "no_merge": _train_no_merge,
                 "answer_altered": _train_answer_altered},
    "search_open": {"half_batch": _search_half_batch,
                    "answer_altered": _search_answer_altered},
    "search_closed": {"half_batch": _search_half_batch,
                      "answer_altered": _search_answer_altered},
}
