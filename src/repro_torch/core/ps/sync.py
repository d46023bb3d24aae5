"""Parameter-server synchronization strategies on one device.

Counterpart of ``repro/core/ps/sync.py``. The paper's system (§4): P
workers each hold a local copy ``L_p`` of the metric; a central server
aggregates gradient pushes and broadcasts fresh parameters. The reference
expresses the consistency models as SPMD programs over a ``workers`` mesh
axis; here the P workers are the leading axis of one tensor on one card,
each step runs the workers' losses one after another, and the reference's
``pmean`` over the axis is a mean over that leading dimension:

  * ``bsp``   — Bulk-Synchronous Parallel: gradients are averaged every
                step; all ``L_p`` stay bit-identical.
  * ``local`` — Local SGD: each worker takes ``tau`` local steps between
                parameter averages (``make_train_chunk`` is the form that
                averages once per ``tau`` steps).
  * ``ssp``   — Stale Synchronous Parallel (Ho et al. 2013): every step
                the global mean gradient is computed, but each worker
                applies a copy of it delayed by ``delay <= s - 1`` steps
                through an s-slot ring buffer; every ``s`` steps the
                parameters are re-averaged so divergence stays bounded.

The SSP delays are an input, ``delays(step) -> (P,) ints``: by default a
``torch.Generator`` seeded from (``PSConfig.seed``, step), so a run is
reproducible; tests feed the reference's ``jax.random`` draws instead.
Placing the workers on several cards waits for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_map, value_and_grad


@dataclasses.dataclass(frozen=True)
class PSConfig:
    n_workers: int
    sync: str = "bsp"        # bsp | local | ssp
    tau: int = 1             # local-SGD sync period (sync="local")
    staleness: int = 0       # SSP bound s (sync="ssp")
    seed: int = 0

    def __post_init__(self):
        if self.sync not in ("bsp", "local", "ssp"):
            raise ValueError(f"unknown sync mode {self.sync!r}")
        if self.sync == "ssp" and self.staleness < 1:
            raise ValueError("ssp requires staleness >= 1")
        if self.sync == "local" and self.tau < 1:
            raise ValueError("local requires tau >= 1")


class PSState(NamedTuple):
    params: Any        # (P, ...) worker-stacked parameter copies
    opt_state: Any     # (P, ...) worker-stacked optimizer states
    step: int          # steps taken
    grad_ring: Any     # (P, s, ...) delayed-gradient ring buffer (ssp) or None


def replicate_for_workers(params, n_workers: int):
    """Stack identical copies along a new leading worker axis."""
    return tree_map(lambda p: p[None].repeat((n_workers,) + (1,) * p.dim()),
                    params)


def worker_mean(params_stacked):
    """Collapse worker copies to their mean (the final model)."""
    return tree_map(lambda p: torch.mean(p, dim=0), params_stacked)


def init_state(opt: Optimizer, params, cfg: PSConfig) -> PSState:
    """Build the worker-stacked PS state from single-copy params."""
    opt_state = opt.init(params)
    pstack = replicate_for_workers(params, cfg.n_workers)
    ostack = replicate_for_workers(opt_state, cfg.n_workers)
    if cfg.sync == "ssp":
        ring = tree_map(lambda p: p.new_zeros(
            (cfg.n_workers, cfg.staleness) + tuple(p.shape)), params)
    else:
        ring = None
    return PSState(params=pstack, opt_state=ostack, step=0, grad_ring=ring)


def default_delays(cfg: PSConfig) -> Callable[[int], torch.Tensor]:
    """SSP delay draws in [0, s-1] per worker, a function of the step:
    a CPU ``torch.Generator`` seeded from (cfg.seed, step)."""
    def delays(step: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed((cfg.seed << 32) + step)
        return torch.randint(0, cfg.staleness, (cfg.n_workers,),
                             generator=gen)
    return delays


def _worker(tree, p: int):
    return tree_map(lambda x: x[p], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _mean(trees):
    return tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *trees)


def make_train_step(loss_fn: Callable, opt: Optimizer, cfg: PSConfig,
                    delays: Optional[Callable[[int], Any]] = None
                    ) -> Callable:
    """The PS step: ``(state, batch) -> (state, metrics)``.

    ``batch`` has a leading (P, local_batch, ...) worker axis;
    ``loss_fn(params, batch) -> (scalar, aux)``. ``delays`` (ssp only)
    gives the P raw delay draws of a step, before the warm-up guard
    ``min(delay, step)``. The ssp ring buffer is updated in place (it is
    the state's largest tensor, P * s copies of the parameters).
    """
    P = cfg.n_workers
    if cfg.sync == "ssp" and delays is None:
        delays = default_delays(cfg)

    def step_fn(state: PSState, batch):
        step = state.step
        params = [_worker(state.params, p) for p in range(P)]
        opt_states = [_worker(state.opt_state, p) for p in range(P)]
        losses, auxes, grads = [], [], []
        for p in range(P):
            (loss, aux), g = value_and_grad(loss_fn, params[p],
                                            _worker(batch, p))
            losses.append(loss)
            auxes.append(aux)
            grads.append(g)

        ring = state.grad_ring
        with torch.no_grad():
            if cfg.sync == "bsp":
                # server aggregates every step: synchronous data-parallel
                gbar = _mean(grads)
                applied = [gbar] * P
            elif cfg.sync == "local":
                applied = grads
            else:  # ssp — bounded-staleness delayed global gradients
                s = cfg.staleness
                gbar = _mean(grads)
                slot = step % s
                tree_map(lambda r, g: r[:, slot].copy_(g), ring, gbar)
                dl = torch.as_tensor(delays(step)).tolist()
                reads = [(step - min(int(d), step)) % s for d in dl]
                applied = [tree_map(lambda r, p=p, i=i: r[p, i], ring)
                           for p, i in enumerate(reads)]
            for p in range(P):
                updates, opt_states[p] = opt.update(applied[p], opt_states[p],
                                                    params[p])
                params[p] = apply_updates(params[p], updates)
            if cfg.sync != "bsp":
                period = cfg.tau if cfg.sync == "local" else cfg.staleness
                if (step + 1) % period == 0:        # server merge
                    params = [_mean(params)] * P

        metrics = {"loss": torch.mean(torch.stack(losses)),
                   **{k: torch.mean(torch.stack([a[k] for a in auxes]))
                      for k in auxes[0]}}
        return PSState(params=_stack(params), opt_state=_stack(opt_states),
                       step=step + 1, grad_ring=ring), metrics

    return step_fn


def make_train_chunk(loss_fn: Callable, opt: Optimizer,
                     cfg: PSConfig) -> Callable:
    """Communication-efficient local SGD: one call = ``tau`` local steps
    per worker and a single parameter average. ``batch`` is shaped
    (P, tau, local_batch, ...)."""
    P = cfg.n_workers

    def chunk_fn(state: PSState, batch):
        params, opt_states, means = [], [], []
        for p in range(P):
            prm, ost = _worker(state.params, p), _worker(state.opt_state, p)
            wb = _worker(batch, p)
            losses = []
            for t in range(cfg.tau):
                (loss, _), g = value_and_grad(loss_fn, prm, _worker(wb, t))
                with torch.no_grad():
                    updates, ost = opt.update(g, ost, prm)
                    prm = apply_updates(prm, updates)
                losses.append(loss)
            params.append(prm)
            opt_states.append(ost)
            means.append(torch.mean(torch.stack(losses)))
        with torch.no_grad():
            merged = _mean(params)          # the single "server" merge
        metrics = {"loss": torch.mean(torch.stack(means))}
        return PSState(params=_stack([merged] * P),
                       opt_state=_stack(opt_states),
                       step=state.step + cfg.tau, grad_ring=None), metrics

    return chunk_fn


def run_steps(train_step, state: PSState, batches, n_steps: int):
    """Host loop helper: returns (state, list-of-metrics)."""
    history = []
    for _ in range(n_steps):
        state, metrics = train_step(state, next(batches))
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history
