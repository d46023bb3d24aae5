"""The closed loop: train -> refresh the serving index -> mine -> train.

Counterpart of ``repro/mining/loop.py``. ``ClosedLoopTrainer`` alternates
PS training steps with serving-index refreshes: every refresh pushes the
current merged L into the index (``MutableIndex.swap_metric`` for mutable
bases, a from-scratch rebuild for frozen ones), optionally promotes it
through a tenant's shadow arm, then re-mines the hard-pair pool with
``HardPairMiner`` and swaps it into the ``MinedPairSource`` feeding the
workers. The same index answering retrieval traffic is the constraint
producer for the trainer; on the card one run launches ``dml_pair`` (the
PS steps), ``metric_topk`` or ``ivf_scan`` (the mining sweeps and shadow
probes) and whatever kernels the caller's ``step_hook`` reaches.

Refresh is governed by an explicit staleness policy: every
``refresh_every`` steps, and/or when the objective plateaus (relative
improvement of the recent loss window below ``plateau_tol``). The history
records how stale each training step's pairs were (``staleness`` = steps
since the pool's metric was current).

The PS runs as ``train_dml_distributed`` does. Without a ``mesh`` the P
workers run on one device (``core/ps/sync.py``). With a worker mesh
(``sync.make_worker_mesh``, one process a worker) every rank builds the
trainer and calls ``run`` with the same arguments; each runs its own
worker's PS step on its block of the state and draws only its own
worker's stream, and the merged L of a refresh is ``worker_mean`` over
the ranks. The serving stack (index, engine, miner and the router, if
given) lives on rank 0 alone, which refreshes the index and mines; the
other ranks wait in the broadcast that carries rank 0's refresh record
and pool to every rank's ``MinedPairSource.set_pool``, as the followers
of ``serve/scan.py``'s ``lead`` wait for rank 0's calls. Every rank
takes the same refresh decisions: they read the step's loss, which the
PS step pmeans over the ranks (bit-identical on every rank), so the
ranks pair the same collectives.

Where the reference differs: the initial factor is an input (``L0``;
without it ``init_params`` draws it from a ``torch.Generator`` seeded
with the PS seed), since the reference's ``jax.random`` draw cannot be
reproduced; and L stays on the device from the PS state through
``swap_metric``, the rebuild and the hook. Each refresh's seconds by
step land in ``timings``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import losses
from repro_torch.core.ps import sync
from repro_torch.core.ps.trainer import (DMLTrainConfig, _initial_factor,
                                         stack_worker_streams)
from repro_torch.device import host_array, resolve_device
from repro_torch.mining.miner import HardPairMiner, MinerConfig
from repro_torch.mining.stream import CurriculumSchedule, MinedPairSource
from repro_torch.optim import Optimizer, sgd
from repro_torch.serve import (ExactIndex, IVFIndex, MutableIndex,
                               RetrievalEngine)


@dataclasses.dataclass(frozen=True)
class ClosedLoopConfig:
    """Everything above the per-step training math.

    train: the inner DMLTrainConfig (steps, batch, lr, sync model).
    miner / schedule: hard-pair filter knobs + curriculum.
    index: which serving backend mines — "mutable-exact" / "mutable-ivf"
      (refreshed via swap_metric) or "exact" / "ivf" (frozen: refresh
      rebuilds from scratch, paying projection + clustering every time).
    index_kwargs: forwarded to the base build (n_clusters, nprobe, ...).
    refresh_every: refresh the index + pool every R steps (0 disables
      periodic refresh — then only plateau triggers fire).
    plateau_window: trailing loss steps inspected for a plateau (0
      disables plateau-triggered refresh).
    plateau_tol: relative improvement of the window's older half over
      its newer half below which the objective counts as plateaued.
    min_refresh_gap: floor between refreshes, so a flat stretch does not
      refresh every step.
    mine_queries: anchors mined per refresh.
    """

    train: DMLTrainConfig
    miner: MinerConfig = MinerConfig()
    schedule: CurriculumSchedule = CurriculumSchedule()
    index: str = "mutable-exact"
    index_kwargs: Optional[dict] = None
    refresh_every: int = 100
    plateau_window: int = 0
    plateau_tol: float = 1e-3
    min_refresh_gap: int = 10
    mine_queries: int = 1024

    def __post_init__(self):
        if self.index not in ("mutable-exact", "mutable-ivf", "exact",
                              "ivf"):
            raise ValueError(f"unknown index kind {self.index!r}")
        if self.refresh_every == 0 and self.plateau_window == 0:
            raise ValueError("no staleness policy: set refresh_every > 0 "
                             "and/or plateau_window > 0")
        if self.mine_queries < 1:
            raise ValueError(f"mine_queries must be >= 1, got "
                             f"{self.mine_queries}")


class ClosedLoopTrainer:
    """Alternates PS training with serving-index refresh + re-mining."""

    def __init__(self, cfg: ClosedLoopConfig, features, labels, *,
                 opt: Optional[Optimizer] = None, L0=None,
                 engine: Optional[RetrievalEngine] = None,
                 router=None, tenant: Optional[str] = None,
                 shadow_probe: int = 8, device=None, mesh=None):
        """Build the serving stack and the mined source (no training yet).

        ``features`` is placed on ``device`` (the card by default; the
        mesh's device with a ``mesh``) once and shared by the index
        build, the miner and the source (an f32 tensor already there is
        used without a copy). ``L0`` is the initial factor (see the
        module docstring). ``mesh``: a worker mesh whose worker axis has
        ``cfg.train.ps.n_workers`` ranks; the serving stack is then
        built on rank 0 only, and the other ranks leave ``engine``,
        ``router`` and ``tenant`` unused.

        ``engine`` lets a caller share an existing serving engine (its
        index must be over ``features`` with row ids 0..n-1); by default
        the trainer stands up its own index of ``cfg.index`` kind under
        L0 — the first refresh replaces that metric.

        ``router`` + ``tenant`` close the loop through the multi-tenant
        front end (serve/tenant.py): each metric-swapping refresh also
        registers the fresh L as the tenant's *shadow arm*, mirrors
        ``shadow_probe`` seeded anchor queries through it, then promotes
        it live.
        """
        self.cfg = cfg
        if (router is None) != (tenant is None):
            raise ValueError("pass router and tenant together (or "
                             "neither)")
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        if mesh is not None:
            sync.check_worker_mesh(cfg.train.ps, mesh)
        if not self.lead:
            router, tenant, engine = None, None, None
        self.router = router
        self.tenant = tenant
        self.shadow_probe = shadow_probe
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.features = torch.as_tensor(features, dtype=torch.float32).to(
            self.device)
        if router is not None:
            router.tenant(tenant)   # unknown tenant fails here, not at
            d_in = self.features.shape[1]                       # refresh
            if router.d_in != d_in:
                raise ValueError(f"router gallery d_in={router.d_in} != "
                                 f"feature dim {d_in}")
        self.labels = host_array(labels)
        self.opt = opt or sgd(cfg.train.lr)
        self.L0 = _initial_factor(cfg.train.dml, L0, cfg.train.ps.seed,
                                  self.device)
        if engine is None and self.lead:
            engine = RetrievalEngine(self._build_index(self.L0),
                                     k_top=cfg.miner.k_neighbors + 1)
        self.engine = engine
        self.miner = HardPairMiner(engine, self.features, self.labels,
                                   cfg.miner) if self.lead else None
        self.source = MinedPairSource(self.features, self.labels,
                                      cfg.schedule, device=self.device)
        self.n_refreshes = 0
        self.refreshes = []          # per-refresh mining stats records
        self.timings = []            # per-refresh seconds by step
        # obs: the loop records into the engine's registry/tracer so the
        # closed loop and the serving path share one snapshot; refreshes
        # are rare control-plane transitions, so their traces bypass
        # sampling (force=True)
        self.registry = getattr(engine, "registry", None)
        self.tracer = getattr(engine, "tracer", None)
        if self.registry is not None:
            self._c_refresh = self.registry.counter(
                "loop_refreshes_total", "index refresh + re-mine cycles")
            self._g_staleness = self.registry.gauge(
                "loop_staleness_steps",
                "training steps since the pair pool's metric was current")
            self._g_mined_frac = self.registry.gauge(
                "loop_mined_frac",
                "curriculum fraction of mined pairs in the current batch")
            self._g_pool = self.registry.gauge(
                "loop_pool_size", "pairs in the live mined pool")
            self._g_neg_yield = self.registry.gauge(
                "loop_neg_yield", "hard-negative yield of the last mine")
            self._g_pos_yield = self.registry.gauge(
                "loop_pos_yield", "hard-positive yield of the last mine")

    def _build_index(self, L):
        kw = dict(self.cfg.index_kwargs or {})
        if self.cfg.index.startswith("mutable"):
            return MutableIndex.build(L, self.features,
                                      base=self.cfg.index.split("-")[1],
                                      retain_raw=True, device=self.device,
                                      **kw)
        if self.cfg.index == "ivf":
            return IVFIndex.build(L, self.features, device=self.device,
                                  **kw)
        return ExactIndex.build(L, self.features, device=self.device, **kw)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- refresh -------------------------------------------------------------

    def refresh(self, L, step: int, swap: bool = True) -> dict:
        """Push L into the index, re-mine, swap the pool. Returns stats.
        ``swap=False`` only re-mines (used for the initial pool, whose
        metric the index was just built with). The refresh's seconds by
        step (``swap_metric``'s host_to_device / project / rebuild, or
        the frozen base's rebuild; promote; mine) are appended to
        ``timings``. Over a mesh every rank calls it: rank 0 refreshes
        and mines, and its record and pool reach every rank (the seconds
        of that broadcast under "broadcast")."""
        if not self.lead:
            t0 = time.perf_counter()
            rec, pool = self._broadcast(None)
            return self._adopt(rec, pool, {"broadcast":
                                           time.perf_counter() - t0})
        trace = (self.tracer.start_trace("refresh", force=True)
                 if self.tracer is not None else None)
        if trace is not None:
            trace.root.set_attrs(step=step, swap=swap)
        times = {}
        if swap:
            L = torch.as_tensor(L, dtype=torch.float32).to(self.device)
            index = self.engine.index
            if isinstance(index, MutableIndex):
                sp = (trace.span("swap_metric") if trace is not None
                      else None)
                swap_t = {}
                index.swap_metric(L, timings=swap_t)  # version bump ->
                times.update(swap_t)                  # engine cache flush
                if sp is not None:
                    sp.set_attrs(rows=index.size).end()
            else:
                # frozen base: rebuild off to the side and repoint the
                # engine (the engine's LRU flushes on the identity change)
                sp = trace.span("rebuild") if trace is not None else None
                t0 = time.perf_counter()
                self.engine.index = self._build_index(L)
                self._sync()
                times["rebuild"] = time.perf_counter() - t0
                if sp is not None:
                    sp.set_attrs(kind=self.cfg.index,
                                 rows=self.engine.index.size).end()
        shadow_stats = None
        if swap and self.router is not None:
            # A/B the fresh metric through the tenant's shadow arm:
            # mirror a few seeded anchors for overlap/latency evidence,
            # then promote — the router's deterministic build makes the
            # promoted view identical to a fresh rebuild under L
            p_sp = trace.span("promote") if trace is not None else None
            t0 = time.perf_counter()
            arm = self.router.register_shadow(self.tenant, L,
                                              sample_rate=1.0)
            probe_rng = np.random.RandomState(
                self.cfg.train.ps.seed + self.n_refreshes)
            probes = probe_rng.randint(
                0, len(self.features),
                size=min(self.shadow_probe, len(self.features)))
            for qid in probes:
                self.router.search(self.tenant, self.features[int(qid)])
            shadow_stats = arm.stats()
            self.router.promote(self.tenant)
            self._sync()
            times["promote"] = time.perf_counter() - t0
            if p_sp is not None:
                p_sp.set_attrs(tenant=self.tenant,
                               n_mirrored=shadow_stats["n_mirrored"],
                               overlap_at_k=shadow_stats["overlap_at_k"]
                               ).end()
        m_sp = trace.span("mine") if trace is not None else None
        t0 = time.perf_counter()
        result = self.miner.mine(n_queries=self.cfg.mine_queries,
                                 seed=self.cfg.train.ps.seed
                                 + self.n_refreshes)
        times["mine"] = time.perf_counter() - t0
        if m_sp is not None:
            m_sp.set_attrs(n_queries=self.cfg.mine_queries,
                           n_pairs=result.stats["n_pairs"],
                           neg_yield=result.stats["neg_yield"]).end()
        rec = {"step": step, "refresh": self.n_refreshes + 1,
               **result.stats}
        if shadow_stats is not None:
            rec["shadow"] = shadow_stats
            rec["promoted_tenant"] = self.tenant
        if self.mesh is not None:
            t0 = time.perf_counter()
            self._broadcast((rec, {k: host_array(v)
                                   for k, v in result.pairs.items()}))
            times["broadcast"] = time.perf_counter() - t0
        self._adopt(rec, result.pairs, times)
        if self.registry is not None:
            self._c_refresh.inc()
            self._g_pool.set(self.source.pool_size)
            self._g_neg_yield.set(result.stats["neg_yield"])
            self._g_pos_yield.set(result.stats["pos_yield"])
            self.registry.event("loop_refresh", step=step,
                                refresh=self.n_refreshes,
                                n_pairs=result.stats["n_pairs"],
                                index_version=result.stats["index_version"])
        if trace is not None:
            self.tracer.finish(trace)
        return rec

    def _broadcast(self, obj):
        """Rank 0's ``obj`` on every rank of the mesh."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _adopt(self, rec: dict, pool, times: dict) -> dict:
        """A refresh's record and pool, on this rank's source and
        history."""
        self.source.set_pool(pool)
        self.n_refreshes += 1
        self.refreshes.append(rec)
        self.timings.append(times)
        return rec

    def _plateaued(self, trace) -> bool:
        w = self.cfg.plateau_window
        if w == 0 or len(trace) < w:
            return False
        recent = np.asarray(trace[-w:], np.float64)
        old = recent[:w // 2].mean()
        new = recent[w // 2:].mean()
        return (old - new) < self.cfg.plateau_tol * max(abs(old), 1e-12)

    # -- training ------------------------------------------------------------

    def run(self, step_hook=None):
        """Train for ``cfg.train.steps`` with interleaved refreshes.

        Returns (L_merged, history): history["steps"] mirrors
        ``train_dml_distributed`` records plus ``staleness`` (steps since
        the pairs' metric was current), ``mined_frac`` and
        ``pool_size``; history["refreshes"] holds one mining-stats record
        per refresh (hard-pair yield, engine QPS, index version);
        history["summary"] has the run-level roll-up (refresh count, mean
        staleness at use, total mined pairs). ``step_hook(step, L)``
        behaves as in ``train_dml_distributed``; L is the merged factor on
        the device. Over a mesh every rank calls ``run`` (and the hook)
        and returns the same L and history, rank 0's engine stats in the
        summary.
        """
        tcfg = self.cfg.train
        mesh, axis = self.mesh, tcfg.ps.axis
        state = sync.init_state(self.opt, self.L0, tcfg.ps)

        def loss_fn(L, batch):
            return losses.dml_pair_loss(L, batch, lam=tcfg.dml.lam,
                                        margin=tcfg.dml.margin,
                                        compute_dtype=tcfg.dml.compute_dtype)

        step_fn = sync.make_train_step(loss_fn, self.opt, tcfg.ps,
                                       mesh=mesh)
        if mesh is None:
            batches = stack_worker_streams(self.source.worker_streams(
                tcfg.ps.n_workers, tcfg.batch_size, tcfg.ps.seed))
        else:
            state = sync.shard_state(state, tcfg.ps, mesh)
            batches = stack_worker_streams([self.source.worker_stream(
                mesh.axis_index(axis), tcfg.ps.n_workers, tcfg.batch_size,
                tcfg.ps.seed)])

        def merged():
            return sync.worker_mean(state.params, mesh, axis)

        # initial pool under L0: the curriculum starts uniform, but the
        # pool must exist before the ramp's first mined batch (no metric
        # swap — the index was just built with L0)
        self.refresh(merged(), step=0, swap=False)
        last_refresh = 0
        staleness_sum = 0
        trace = []
        history = []
        for t in range(tcfg.steps):
            if t > 0 and self._due(t, last_refresh, trace):
                self.refresh(merged(), step=t)
                last_refresh = t
                trace = []           # plateau window restarts post-refresh
            state, metrics = step_fn(state, next(batches))
            loss = float(metrics["loss"])
            trace.append(loss)
            staleness_sum += t - last_refresh
            if self.registry is not None:   # per-step staleness gauges
                self._g_staleness.set(t - last_refresh)
                self._g_mined_frac.set(self.cfg.schedule.mined_frac(t))
                self._g_pool.set(self.source.pool_size)
            if t % tcfg.log_every == 0 or t == tcfg.steps - 1:
                rec = {"step": t,
                       **{k: float(v) for k, v in metrics.items()},
                       "staleness": t - last_refresh,
                       "mined_frac": self.cfg.schedule.mined_frac(t),
                       "pool_size": self.source.pool_size}
                if step_hook is not None:
                    out = step_hook(t, merged())
                    if out is not None:
                        rec["hook"] = out
                history.append(rec)
        L = merged()
        engine_stats = self.engine.stats() if self.lead else None
        if mesh is not None:
            engine_stats = self._broadcast(engine_stats)
        summary = {
            "n_refreshes": self.n_refreshes,
            "mean_staleness": staleness_sum / max(tcfg.steps, 1),
            "total_mined_pairs": int(sum(r["n_pairs"]
                                         for r in self.refreshes)),
            "neg_yield": float(np.mean([r["neg_yield"]
                                        for r in self.refreshes])),
            "pos_yield": float(np.mean([r["pos_yield"]
                                        for r in self.refreshes])),
            "engine": engine_stats,
        }
        return L, {"steps": history, "refreshes": self.refreshes,
                   "summary": summary}

    def _due(self, t: int, last_refresh: int, trace) -> bool:
        gap = t - last_refresh
        if self.cfg.refresh_every and gap >= self.cfg.refresh_every:
            return True
        return gap >= self.cfg.min_refresh_gap and self._plateaued(trace)
