"""Parameter-server synchronization strategies, on one device or one
worker a rank.

Counterpart of ``repro/core/ps/sync.py``. The paper's system (§4): P
workers each hold a local copy ``L_p`` of the metric; a central server
aggregates gradient pushes and broadcasts fresh parameters. The reference
expresses the consistency models as SPMD programs over a ``workers`` mesh
axis, and so does the port over a live mesh (``make_worker_mesh``, one
process a worker): each rank holds its ``(1, ...)`` block of the
worker-stacked state and runs its own worker, and the server is the
axis collectives of ``sharding/partition.py``. Without a mesh the P
workers are the leading axis of one tensor on one card, each step runs
the workers' losses one after another, and the reference's ``pmean``
over the axis is a mean over that leading dimension:

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
Over a mesh every rank draws the same table and takes its own entry.
The async PS (``core/ps/simulator.py``) stays one process: its workers
are threads with a CUDA stream each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import LiveMesh
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.sharding import partition
from repro_torch.tree import tree_map, value_and_grad


@dataclasses.dataclass(frozen=True)
class PSConfig:
    n_workers: int
    sync: str = "bsp"        # bsp | local | ssp
    tau: int = 1             # local-SGD sync period (sync="local")
    staleness: int = 0       # SSP bound s (sync="ssp")
    seed: int = 0
    axis: str = "workers"    # mesh axis name that indexes workers

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


def make_worker_mesh(n_workers: int, axis: str = "workers") -> LiveMesh:
    """1-D live mesh over the ranks of the process group, one worker a
    rank (the group must have ``n_workers`` ranks)."""
    return LiveMesh((axis,), (n_workers,))


def replicate_for_workers(params, n_workers: int):
    """Stack identical copies along a new leading worker axis."""
    return tree_map(lambda p: p[None].repeat((n_workers,) + (1,) * p.dim()),
                    params)


def worker_mean(params_stacked, mesh: Optional[LiveMesh] = None,
                axis: str = "workers"):
    """Collapse worker copies to their mean (the final model); over a
    mesh, the pmean of this rank's copy (every rank gets the mean)."""
    if mesh is not None:
        return partition.pmean(_worker(params_stacked, 0), axis, mesh)
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


def state_sharding(mesh, cfg: PSConfig, state: PSState) -> PSState:
    """Specs of a PSState (the reference's ``state_sharding``): the
    worker-stacked leaves on the worker axis, the rest replicated; on a
    live mesh as ``partition.NamedSharding`` pairs on it."""
    ax = (cfg.axis,)
    specs = PSState(
        params=tree_map(lambda x: ax, state.params),
        opt_state=tree_map(lambda x: ax if x.dim() >= 1 and
                           x.shape[0] == cfg.n_workers else (),
                           state.opt_state),
        step=(),
        grad_ring=None if state.grad_ring is None
        else tree_map(lambda x: ax, state.grad_ring))
    if isinstance(mesh, LiveMesh):
        return partition.named(mesh, specs)
    return specs


def shard_state(state: PSState, cfg: PSConfig, mesh: LiveMesh) -> PSState:
    """This rank's ``(1, ...)`` block of a worker-stacked PSState, on the
    mesh's device."""
    shardings = state_sharding(mesh, cfg, state)
    own = lambda x, sharding: sharding.place(x)  # noqa: E731
    return PSState(
        params=tree_map(own, state.params, shardings.params),
        opt_state=tree_map(own, state.opt_state, shardings.opt_state),
        step=state.step,
        grad_ring=None if state.grad_ring is None
        else tree_map(own, state.grad_ring, shardings.grad_ring))


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


def check_worker_mesh(cfg: PSConfig, mesh: LiveMesh) -> None:
    """Raise unless ``mesh``'s worker axis has one rank a worker."""
    if mesh.axis_size(cfg.axis) != cfg.n_workers:
        raise ValueError(f"{cfg.n_workers} workers on a mesh whose "
                         f"{cfg.axis!r} axis has "
                         f"{mesh.axis_size(cfg.axis)} ranks")


def _workers(cfg: PSConfig, mesh: Optional[LiveMesh]):
    """(this process's workers, the first one's index, the server merge
    of a list of their trees): all P and their mean on one device; over
    a mesh this rank's worker and the pmean across the worker axis."""
    if mesh is None:
        return cfg.n_workers, 0, _mean
    check_worker_mesh(cfg, mesh)
    return 1, mesh.axis_index(cfg.axis), \
        lambda trees: partition.pmean(trees[0], cfg.axis, mesh)


def make_train_step(loss_fn: Callable, opt: Optimizer, cfg: PSConfig,
                    delays: Optional[Callable[[int], Any]] = None,
                    mesh: Optional[LiveMesh] = None) -> Callable:
    """The PS step: ``(state, batch) -> (state, metrics)``.

    ``batch`` has a leading (P, local_batch, ...) worker axis;
    ``loss_fn(params, batch) -> (scalar, aux)``. ``delays`` (ssp only)
    gives the P raw delay draws of a step, before the warm-up guard
    ``min(delay, step)``. The ssp ring buffer is updated in place (it is
    the state's largest tensor, P * s copies of the parameters).

    Over a worker ``mesh`` every rank calls the step with its ``(1,
    ...)`` blocks of the state (``shard_state``) and of the batch, and
    the server is the reference's collectives: bsp the pmean of the
    gradients every step, local and ssp the pmean of the parameters on
    sync steps, ssp the pmean of the gradients into the ring (each rank
    reads entry ``axis_index`` of ``delays(step)``), the metrics pmeaned.
    """
    P, first, merge = _workers(cfg, mesh)
    if cfg.sync == "ssp" and delays is None:
        delays = default_delays(cfg)

    def step_fn(state: PSState, batch):
        step = state.step
        params = [_worker(state.params, p) for p in range(P)]
        opt_states = [_worker(state.opt_state, p) for p in range(P)]
        metrics, grads = [], []
        for p in range(P):
            (loss, aux), g = value_and_grad(loss_fn, params[p],
                                            _worker(batch, p))
            metrics.append({"loss": loss, **aux})
            grads.append(g)

        ring = state.grad_ring
        with torch.no_grad():
            if cfg.sync == "bsp":
                # server aggregates every step: synchronous data-parallel
                gbar = merge(grads)
                applied = [gbar] * P
            elif cfg.sync == "local":
                applied = grads
            else:  # ssp — bounded-staleness delayed global gradients
                s = cfg.staleness
                gbar = merge(grads)
                slot = step % s
                tree_map(lambda r, g: r[:, slot].copy_(g), ring, gbar)
                dl = torch.as_tensor(delays(step)).tolist()
                reads = [(step - min(int(d), step)) % s
                         for d in dl[first:first + P]]
                applied = [tree_map(lambda r, p=p, i=i: r[p, i], ring)
                           for p, i in enumerate(reads)]
            for p in range(P):
                updates, opt_states[p] = opt.update(applied[p], opt_states[p],
                                                    params[p])
                params[p] = apply_updates(params[p], updates)
            if cfg.sync != "bsp":
                period = cfg.tau if cfg.sync == "local" else cfg.staleness
                if (step + 1) % period == 0:        # server merge
                    params = [merge(params)] * P
            metrics = merge(metrics)

        return PSState(params=_stack(params), opt_state=_stack(opt_states),
                       step=step + 1, grad_ring=ring), metrics

    return step_fn


def make_train_chunk(loss_fn: Callable, opt: Optimizer, cfg: PSConfig,
                     mesh: Optional[LiveMesh] = None) -> Callable:
    """Communication-efficient local SGD: one call = ``tau`` local steps
    per worker and a single parameter average. ``batch`` is shaped
    (P, tau, local_batch, ...); over a worker ``mesh``, this rank's
    ``(1, tau, ...)`` block, and the average is one pmean."""
    P, _, merge = _workers(cfg, mesh)

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
            means.append({"loss": torch.mean(torch.stack(losses))})
        with torch.no_grad():
            merged = merge(params)          # the single "server" merge
            metrics = merge(means)
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
