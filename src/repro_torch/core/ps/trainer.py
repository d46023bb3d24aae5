"""High-level DML training loops on the PS sync layer (counterpart of
``repro/core/ps/trainer.py``).

``train_dml_distributed`` is the production-shaped entry point: it takes
a pair dataset or a pluggable pair source, partitions it over workers
(paper §4.1), builds the PS step for the requested consistency model and
runs it, returning the merged metric plus the objective trace.
``train_dml_single`` is the single-worker reference loop. Over a worker
mesh (``sync.make_worker_mesh``) every rank runs ``train_dml_distributed``
as its own worker, drawing only its own stream.

Both run on the card unless ``device="cpu"`` is given; there the loss is
the fused ``dml_pair`` kernel with its closed-form backward
(``core/losses.py``). Both take an optional ``L0``: the reference draws
its initial factor from ``jax.random``, which the port cannot reproduce,
so parity runs carry the reference's L0 across. Without ``L0`` the factor
comes from ``init_params`` with a ``torch.Generator`` seeded from the
config's seed. Both are shape-agnostic in ``d_out`` (square or low-rank
rectangular L).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import dml, losses
from repro_torch.core.ps import sync
from repro_torch.data.loader import partition_pairs
from repro_torch.data.pairs import pair_batches
from repro_torch.device import resolve_device
from repro_torch.optim import Optimizer, sgd
from repro_torch.tree import value_and_grad


@dataclasses.dataclass(frozen=True)
class DMLTrainConfig:
    dml: dml.DMLConfig
    ps: sync.PSConfig
    batch_size: int = 1000        # per-worker pairs per step (paper: 100/1000)
    steps: int = 200
    lr: float = 1e-2
    log_every: int = 10


def stack_worker_streams(streams) -> Iterator[dict]:
    """Zip per-worker batch streams into (P, B, ...) stacked batches."""
    while True:
        bs = [next(s) for s in streams]
        yield {k: torch.stack([b[k] for b in bs]) for k in bs[0]}


def make_worker_streams(pairs, n_workers: int, batch_size: int, seed: int,
                        device=None):
    """Per-worker batch iterators from either pair representation: a
    pre-sampled pair dict (partitioned over workers as in paper §4.1,
    then streamed with ``pair_batches`` on ``device``) or any object with
    ``worker_streams(n_workers, batch_size, seed)`` (a pluggable source
    that places its own batches)."""
    if hasattr(pairs, "worker_streams"):
        return pairs.worker_streams(n_workers, batch_size, seed)
    dev = resolve_device(device)
    shards = partition_pairs(pairs, n_workers)
    return [pair_batches(s, batch_size, seed=seed + i, device=dev)
            for i, s in enumerate(shards)]


def _initial_factor(cfg: dml.DMLConfig, L0, seed: int, dev) -> torch.Tensor:
    if L0 is not None:
        if not torch.is_tensor(L0):
            L0 = torch.from_numpy(np.array(L0, copy=True))
        return L0.to(device=dev, dtype=cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return dml.init_params(cfg, gen, dev)


def train_dml_distributed(cfg: DMLTrainConfig, pairs,
                          opt: Optional[Optimizer] = None, L0=None,
                          delays=None, step_hook=None, device=None,
                          mesh=None):
    """Distributed DML training (paper §4) under a chosen sync model.

    ``pairs`` is either a pair dict (the uniform path) or a pluggable
    pair source (see ``make_worker_streams``). ``delays`` feeds the SSP
    delay draws (``sync.make_train_step``). ``step_hook(step, L)``, if
    given, is called with the merged metric at every logged step and its
    return value (when not None) lands in that history record under
    ``"hook"``.

    With a worker ``mesh`` every rank of it calls this with the same
    arguments: rank p holds worker p's block of the state on the mesh's
    device (``device`` is ignored) and draws only worker p's stream,
    ``pair_batches(shard_p, batch, seed=seed + p)``, the batches the
    one-process path stacks at index p.

    Returns (L_merged, history) — history is a list of per-step metric
    dicts of floats; over a mesh every rank returns the merged L.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    opt = opt or sgd(cfg.lr)
    L0 = _initial_factor(cfg.dml, L0, cfg.ps.seed, dev)
    state = sync.init_state(opt, L0, cfg.ps)

    def loss_fn(L, batch):
        return losses.dml_pair_loss(L, batch, lam=cfg.dml.lam,
                                    margin=cfg.dml.margin,
                                    compute_dtype=cfg.dml.compute_dtype)

    step_fn = sync.make_train_step(loss_fn, opt, cfg.ps, delays=delays,
                                   mesh=mesh)
    streams = make_worker_streams(pairs, cfg.ps.n_workers, cfg.batch_size,
                                  cfg.ps.seed, device=dev)
    if mesh is None:
        batches = stack_worker_streams(streams)
    else:
        state = sync.shard_state(state, cfg.ps, mesh)
        batches = stack_worker_streams(
            [streams[mesh.axis_index(cfg.ps.axis)]])

    def merged():
        return sync.worker_mean(state.params, mesh, cfg.ps.axis)

    history = []
    for t in range(cfg.steps):
        state, metrics = step_fn(state, next(batches))
        if t % cfg.log_every == 0 or t == cfg.steps - 1:
            rec = {"step": t, **{k: float(v) for k, v in metrics.items()}}
            if step_hook is not None:
                out = step_hook(t, merged())
                if out is not None:
                    rec["hook"] = out
            history.append(rec)
    return merged(), history


def train_dml_single(dml_cfg: dml.DMLConfig, pairs: dict, steps: int = 200,
                     batch_size: int = 1000, lr: float = 1e-2, seed: int = 0,
                     opt: Optional[Optimizer] = None, eval_pairs=None,
                     eval_every: int = 0, L0=None, device=None):
    """Single-worker reference loop (the t_1 baseline of the speedup
    curves). Returns (L, history)."""
    dev = resolve_device(device)
    opt = opt or sgd(lr)
    L = _initial_factor(dml_cfg, L0, seed, dev)
    opt_state = opt.init(L)

    def loss_fn(p, b):
        return losses.dml_pair_loss(p, b, lam=dml_cfg.lam,
                                    margin=dml_cfg.margin)

    if eval_pairs is not None and eval_every:
        ev = {k: torch.as_tensor(v).to(dev) for k, v in eval_pairs.items()}
    batches = pair_batches(pairs, batch_size, seed=seed, device=dev)
    history = []
    for t in range(steps):
        (loss, _), g = value_and_grad(loss_fn, L, next(batches))
        with torch.no_grad():
            updates, opt_state = opt.update(g, opt_state, L)
            L = L + updates
        rec = {"step": t, "loss": float(loss)}
        if eval_pairs is not None and eval_every and t % eval_every == 0:
            scores = dml.pair_scores(L, ev["xs"], ev["ys"])
            rec["ap"] = float(dml.average_precision(scores, ev["sim"]))
        history.append(rec)
    return L, history
