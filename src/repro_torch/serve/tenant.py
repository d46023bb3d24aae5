"""Multi-tenant metric serving: N learned metrics over one shared gallery.

Counterpart of ``repro/serve/tenant.py``. The paper's training side
produces *many* metric factors — one per product surface, per experiment
arm, per region — but the raw gallery they rank is the same feature
store. Running one full serving stack per metric multiplies the dominant
cost (resident gallery bytes) by the tenant count for no reason: the raw
rows are identical, only the projection through L differs.

``TenantRouter`` keeps the raw rows **once**, on its device (the card
unless the caller asks for the CPU), and gives every tenant its own
*projected view*:

  * each tenant owns an ``(d_out, d_in)`` factor L, a backend choice
    (exact / ivf / ivfpq) with build kwargs, and its own
    ``RetrievalEngine`` (hot-query LRU included) over a frozen view
    built by projecting the live shared rows through its L in blocks of
    ``VIEW_BLOCK`` rows (no whole-store copy; the blocks follow from the
    store and the dead mask alone, so two builds of one view do the
    same work) — cold tenants pay the build lazily on first query (or
    eagerly via ``warm``);
  * the store is a list of row blocks that are never written: ``extend``
    appends a block, ``remove`` marks rows in a host dead mask, so ids
    stay stable positions and growth copies nothing already stored;
  * tenant engines record into ``registry.scoped(tenant=name)``, so one
    base ``MetricsRegistry`` carries every tenant's ``engine_*`` series
    distinguished by the ``tenant`` label;
  * per-tenant SLO: a priority class + deadline that ``submit`` maps
    into the attached ``RequestScheduler`` via its tenant routes
    (batches never mix tenants — one engine call per batch);
  * gallery mutation (``extend`` / ``remove``) bumps a generation
    counter; stale warm views rebuild lazily on next use;
  * ``save_tenants`` / ``load_tenants`` persist the whole tenant set in
    the reference's format — shared rows once plus each warm tenant's
    built view through the snapshot machinery, gated on reload by the
    manifest L fingerprint (``TenantFingerprintError``) — so each package
    loads the other's tenant sets;
  * ``ShadowArm``: a tenant registers a *candidate* L that receives
    mirrored (deterministically sampled) traffic. The arm accumulates
    overlap-vs-live and latency deltas in the registry; ``promote``
    atomically repoints the live engine at the shadow view — the same
    deterministic build a fresh router would produce, bit for bit.

View positions map to store ids through host int64 arrays, since the
engine returns numpy answers.
"""

from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import Future
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import host_array, resolve_device
from repro_torch.kernels.metric_topk import project_gallery
from repro_torch.obs import MetricsRegistry, Tracer, index_memory
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.engine import RetrievalEngine
from repro_torch.serve.index import ExactIndex
from repro_torch.serve.ivf import IVFIndex
from repro_torch.serve.pq import IVFPQIndex
from repro_torch.serve.snapshot import l_fingerprint, load_index, save_index

_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")
_BACKENDS = ("exact", "ivf", "ivfpq")
TENANTS_MANIFEST = "tenants.json"
VIEW_BLOCK = 16_384         # store rows projected a step by _build_view


class TenantError(ValueError):
    """Tenant-layer misuse: unknown/duplicate tenant, bad name, no
    scheduler attached, dimension mismatch."""


class TenantFingerprintError(TenantError):
    """A persisted view's L fingerprint does not match the tenant's
    factor — the snapshot was built under a different metric."""


class Tenant:
    """One tenant's serving state. Created via ``TenantRouter.add_tenant``
    — not directly. ``engine`` is None until the first build (cold).
    ``L`` is the factor as a host f32 array (the views hold it on the
    router's device)."""

    __slots__ = ("name", "L", "fingerprint", "backend", "build_kwargs",
                 "k_top", "cache_size", "priority", "deadline_s",
                 "engine", "ids", "built_generation", "shadow",
                 "n_requests")

    def __init__(self, name, L, backend, build_kwargs, k_top, cache_size,
                 priority, deadline_s):
        self.name = name
        self.L = host_array(L, np.float32)
        self.fingerprint = l_fingerprint(self.L)
        self.backend = backend
        self.build_kwargs = dict(build_kwargs)
        self.k_top = k_top
        self.cache_size = cache_size
        self.priority = priority
        self.deadline_s = deadline_s
        self.engine: Optional[RetrievalEngine] = None
        # view position -> shared-store row id, frozen at build time
        self.ids: Optional[np.ndarray] = None
        self.built_generation = -1
        self.shadow: Optional[ShadowArm] = None
        self.n_requests = 0

    @property
    def warm(self) -> bool:
        return self.engine is not None


class ShadowArm:
    """A candidate metric riding a live tenant's traffic.

    Mirrored queries (deterministic accumulator at ``sample_rate``) run
    against a view built under the candidate L; per-query top-k overlap
    with the live answer and the live/shadow latency totals accumulate
    here and in the registry. The arm never answers client traffic —
    ``promote`` makes it live."""

    __slots__ = ("L", "fingerprint", "sample_rate", "engine", "ids",
                 "built_generation", "_acc", "n_mirrored", "overlap_sum",
                 "n_rows", "live_s", "shadow_s")

    def __init__(self, L, sample_rate: float):
        self.L = host_array(L, np.float32)
        self.fingerprint = l_fingerprint(self.L)
        self.sample_rate = float(sample_rate)
        self.engine: Optional[RetrievalEngine] = None
        self.ids: Optional[np.ndarray] = None
        self.built_generation = -1
        self._acc = 0.0         # deterministic sampler: acc += rate
        self.n_mirrored = 0
        self.overlap_sum = 0.0  # sum of per-row |live ∩ shadow| / k
        self.n_rows = 0
        self.live_s = 0.0
        self.shadow_s = 0.0

    def take(self) -> bool:
        """Mirror this request? Deterministic: fires every time the
        accumulated rate crosses 1 (rate 0.25 -> every 4th request)."""
        self._acc += self.sample_rate
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    def stats(self) -> dict:
        mean = (self.overlap_sum / self.n_rows) if self.n_rows else 0.0
        ratio = (self.shadow_s / self.live_s) if self.live_s > 0 else 0.0
        return {"fingerprint": self.fingerprint,
                "sample_rate": self.sample_rate,
                "n_mirrored": self.n_mirrored,
                "overlap_at_k": mean,
                "latency_ratio": ratio,
                "warm": self.engine is not None}


def _store_block(rows, dev: torch.device, copy: bool = True) -> torch.Tensor:
    """Rows as an f32 block on ``dev``, copied from the caller's data.
    ``copy=False`` takes a contiguous f32 tensor already on ``dev`` as it
    is (the block then shares the caller's memory) and raises for any
    other input."""
    if not copy:
        if not (torch.is_tensor(rows) and rows.device.type == dev.type
                and dev.index in (None, rows.device.index)
                and rows.dtype == torch.float32 and rows.is_contiguous()):
            raise TenantError(f"copy=False takes a contiguous float32 "
                              f"tensor on {dev}")
        return rows.detach()
    if torch.is_tensor(rows):
        return rows.detach().to(device=dev, dtype=torch.float32,
                                copy=True).contiguous()
    return torch.tensor(np.asarray(rows, np.float32), device=dev)


class TenantRouter:
    """N learned metrics over one shared raw gallery.

    ``gallery`` (M, d_in) is copied into the first block of the store on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``), as the reference copies it into an immutable
    array. ``copy=False`` takes a contiguous float32 tensor already on
    ``device`` without a copy (a store too large to hold twice): the
    router then shares the caller's memory, and a later write there
    changes what every view projects without a generation bump, so the
    caller must not write to it. Thread-safety: gallery mutation, tenant
    registration, and view (re)builds serialize on an internal lock; the
    per-tenant engines follow the engine's own contract (serve from one
    worker — the attached scheduler provides exactly that; the router's
    direct ``search`` is for tests, tools, and single-threaded callers).
    """

    def __init__(self, gallery, *, device=None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Clock] = None,
                 k_top: int = 10, copy: bool = True):
        self.device = resolve_device(device)
        if len(getattr(gallery, "shape", np.shape(gallery))) != 2:
            raise TenantError(f"gallery must be (M, d_in), got shape "
                              f"{tuple(np.shape(gallery))}")
        first = _store_block(gallery, self.device, copy)
        self._blocks = [first]              # the single shared raw store
        self._n_rows = first.shape[0]
        self._dead = np.zeros(self._n_rows, dtype=bool)
        self._generation = 0
        self.k_top = k_top
        self.clock = clock if clock is not None else SystemClock()
        self.registry = (registry if registry is not None
                         else MetricsRegistry(clock=self.clock))
        self.tracer = (tracer if tracer is not None
                       else Tracer(clock=self.clock, sample_rate=0.0))
        self.scheduler = None
        self._tenants: Dict[str, Tenant] = {}
        self._lock = threading.RLock()
        r = self.registry
        self._c_requests = r.counter(
            "tenant_requests_total", "router requests by tenant",
            labelnames=("tenant",))
        self._g_warm = r.gauge(
            "tenant_warm", "1 when the tenant's view is built",
            labelnames=("tenant",))
        self._c_mirrored = r.counter(
            "shadow_mirrored_total", "queries mirrored to the shadow arm",
            labelnames=("tenant",))
        self._g_overlap = r.gauge(
            "shadow_overlap_at_k",
            "running mean top-k overlap of shadow vs live answers",
            labelnames=("tenant",))
        self._g_lat_ratio = r.gauge(
            "shadow_latency_ratio",
            "shadow / live accumulated search seconds",
            labelnames=("tenant",))
        self._c_promotions = r.counter(
            "tenant_promotions_total", "shadow arms promoted to live",
            labelnames=("tenant",))

    # -- gallery ------------------------------------------------------------

    @property
    def d_in(self) -> int:
        return self._blocks[0].shape[1]

    @property
    def gallery_rows(self) -> int:
        return self._n_rows

    @property
    def live_rows(self) -> int:
        return int((~self._dead).sum())

    @property
    def generation(self) -> int:
        return self._generation

    def rows(self) -> np.ndarray:
        """The whole store (dead rows included) as one host array."""
        with self._lock:
            return np.concatenate([b.cpu().numpy() for b in self._blocks])

    def extend(self, rows) -> np.ndarray:
        """Append raw rows to the shared store as a new block (nothing
        stored is copied). Returns their (stable) ids. Warm views go
        stale and rebuild lazily on next use."""
        shape = tuple(getattr(rows, "shape", np.shape(rows)))
        if len(shape) != 2 or shape[1] != self.d_in:
            raise TenantError(f"rows must be (n, {self.d_in}), got shape "
                              f"{shape}")
        block = _store_block(rows, self.device)
        with self._lock:
            start = self._n_rows
            self._blocks.append(block)
            self._n_rows += block.shape[0]
            self._dead = np.concatenate(
                [self._dead, np.zeros(block.shape[0], dtype=bool)])
            self._generation += 1
            return np.arange(start, self._n_rows, dtype=np.int64)

    def remove(self, ids: Sequence[int]) -> int:
        """Tombstone rows by id; returns how many were newly dead."""
        with self._lock:
            ids = np.asarray(ids, np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= self._n_rows):
                raise TenantError(f"row id out of range [0, "
                                  f"{self._n_rows})")
            newly = int((~self._dead[ids]).sum())
            self._dead[ids] = True
            if newly:
                self._generation += 1
            return newly

    # -- tenants ------------------------------------------------------------

    def add_tenant(self, name: str, L, *, backend: str = "exact",
                   build_kwargs: Optional[dict] = None,
                   k_top: Optional[int] = None,
                   cache_size: int = 1024,
                   priority: str = "interactive",
                   deadline_s: Optional[float] = None) -> Tenant:
        """Register a tenant (cold — no view built yet).

        Args:
          name: ``[A-Za-z0-9_-]+`` (``#`` is reserved for shadow scopes).
          L: (d_out, d_in) metric factor; d_in must match the gallery.
          backend: "exact" | "ivf" | "ivfpq" (view type built on warm).
          build_kwargs: forwarded to the backend's ``build_projected``
            (n_clusters, nprobe, rerank_depth, ...). Builds are
            deterministic (seed=0 default), which is what makes shadow
            promotion bit-identical to a fresh build.
          k_top / cache_size: per-tenant engine shape.
          priority / deadline_s: the tenant's SLO — submit() maps these
            into the attached scheduler's priority classes.
        """
        if not _NAME_RE.match(name or ""):
            raise TenantError(f"invalid tenant name {name!r} (want "
                              f"[A-Za-z0-9_-]+)")
        if backend not in _BACKENDS:
            raise TenantError(f"unknown backend {backend!r} "
                              f"(have {_BACKENDS})")
        L = self._check_factor(L)
        with self._lock:
            if name in self._tenants:
                raise TenantError(f"tenant {name!r} already registered")
            t = Tenant(name, L, backend, build_kwargs or {},
                       self.k_top if k_top is None else k_top,
                       cache_size, priority, deadline_s)
            self._tenants[name] = t
        self._g_warm.set(0, tenant=name)
        self.registry.event("tenant_add", tenant=name, backend=backend,
                            fingerprint=t.fingerprint)
        return t

    def _check_factor(self, L) -> np.ndarray:
        L = host_array(L, np.float32)
        if L.ndim != 2 or L.shape[1] != self.d_in:
            raise TenantError(f"L must be (d_out, {self.d_in}), got "
                              f"shape {L.shape}")
        return L

    def tenant(self, name: str) -> Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise TenantError(f"unknown tenant {name!r} "
                              f"(have {sorted(self._tenants)})")
        return t

    def tenants(self) -> tuple:
        return tuple(self._tenants)

    def _project_live(self, L: torch.Tensor):
        """(gp (n_live, d_out), gn (n_live,), ids (n_live,) int64 host):
        the live store rows projected through L, VIEW_BLOCK store rows a
        step (only a block's live rows are gathered, never the store)."""
        ids = np.flatnonzero(~self._dead).astype(np.int64)
        gp = torch.empty((len(ids), L.shape[0]), dtype=torch.float32,
                         device=self.device)
        gn = torch.empty((len(ids),), dtype=torch.float32,
                         device=self.device)
        pos = start = 0
        for block in self._blocks:
            for s in range(0, block.shape[0], VIEW_BLOCK):
                rows = block[s:s + VIEW_BLOCK]
                alive = ~self._dead[start + s:start + s + rows.shape[0]]
                n = int(alive.sum())
                if n < rows.shape[0]:
                    if n == 0:
                        continue
                    rows = rows[torch.from_numpy(np.flatnonzero(alive))
                                .to(self.device)]
                gp[pos:pos + n], gn[pos:pos + n] = project_gallery(L, rows)
                pos += n
            start += block.shape[0]
        return gp, gn, ids

    def _build_view(self, L, backend: str, kwargs: dict):
        """(index, ids): project the live shared rows through L into a
        frozen view. Deterministic for fixed (store, dead mask, L,
        kwargs)."""
        L = torch.from_numpy(L).to(self.device)
        gp, gn, live = self._project_live(L)
        if backend == "exact":
            view = ExactIndex.from_projected(L, gp, gn, device=self.device)
        elif backend == "ivf":
            view = IVFIndex.build_projected(L, gp, gn, device=self.device,
                                            **kwargs)
        else:
            view = IVFPQIndex.build_projected(L, gp, gn, device=self.device,
                                              **kwargs)
        return view, live

    def _attach_view(self, t: Tenant, scope: str, arm, view, ids) -> None:
        """Point ``t`` (or its shadow ``arm``) at a built view, creating
        the scoped engine on first warm and repointing the index (LRU
        flush via identity change) thereafter."""
        holder = arm if arm is not None else t
        if holder.engine is None:
            holder.engine = RetrievalEngine(
                view, k_top=t.k_top, cache_size=t.cache_size,
                registry=self.registry.scoped(tenant=scope),
                tracer=self.tracer, clock=self.clock)
        else:
            holder.engine.index = view      # identity change flushes LRU
        holder.ids = ids
        holder.built_generation = self._generation

    def warm(self, name: str) -> Tenant:
        """Build (or freshen) the tenant's projected view now instead of
        on first query. Idempotent when already fresh."""
        t = self.tenant(name)
        with self._lock:
            if t.engine is None or t.built_generation != self._generation:
                view, ids = self._build_view(t.L, t.backend,
                                             t.build_kwargs)
                self._attach_view(t, t.name, None, view, ids)
                if self.scheduler is not None:
                    # (re)derive the route ladder from the fresh view
                    self.scheduler.add_route(t.name, t.engine)
                self._g_warm.set(1, tenant=t.name)
                self.registry.event("tenant_warm", tenant=t.name,
                                    generation=self._generation,
                                    rows=int(ids.shape[0]))
        return t

    def _warm_shadow(self, t: Tenant) -> ShadowArm:
        arm = t.shadow
        with self._lock:
            if (arm.engine is None
                    or arm.built_generation != self._generation):
                view, ids = self._build_view(arm.L, t.backend,
                                             t.build_kwargs)
                self._attach_view(t, f"{t.name}#shadow", arm, view, ids)
        return arm

    # -- serving ------------------------------------------------------------

    def _translate(self, t_ids: np.ndarray, idxs: np.ndarray):
        """View positions -> stable shared-store ids (-1 stays -1: IVF
        pads short probes with -1)."""
        safe = np.clip(idxs, 0, t_ids.shape[0] - 1)
        return np.where(idxs >= 0, t_ids[safe], -1).astype(np.int64)

    def search(self, name: str, queries, k_top: Optional[int] = None,
               **topk_kw):
        """Synchronous per-tenant search: lazy-warms, serves from the
        tenant engine, translates view positions to stable row ids, and
        mirrors to the shadow arm when one is registered. queries (d,)
        or (n, d); returns (dists, ids) shaped like ``engine.search``."""
        t = self.warm(name)
        self._c_requests.inc(tenant=name)
        t.n_requests += 1
        t0 = self.clock.now()
        dists, idxs = t.engine.search(queries, k_top=k_top, **topk_kw)
        elapsed = self.clock.now() - t0
        ids = self._translate(t.ids, idxs)
        if t.shadow is not None and t.shadow.take():
            k = t.k_top if k_top is None else k_top
            self._mirror(t, queries, k, ids, elapsed, topk_kw)
        return dists, ids

    def submit(self, name: str, query, k_top: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Submit one (d,) query through the attached scheduler under the
        tenant's route + SLO (priority class, deadline). Returns a Future
        resolving to (dists (k,), ids (k,)) with stable row ids; shadow
        mirroring happens on completion, off the client's future."""
        if self.scheduler is None:
            raise TenantError("no scheduler attached "
                              "(attach_scheduler first)")
        t = self.warm(name)
        self._c_requests.inc(tenant=name)
        t.n_requests += 1
        dl = t.deadline_s if deadline_s is None else deadline_s
        t0 = self.clock.now()
        inner = self.scheduler.submit(query, k_top=k_top,
                                      priority=t.priority,
                                      deadline_s=dl, route=t.name)
        outer: Future = Future()
        outer.set_running_or_notify_cancel()
        q = np.asarray(query, np.float32)
        k = t.k_top if k_top is None else k_top
        t_ids = t.ids               # frozen: rebuilds swap the array out

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
                return
            dists, idxs = f.result()
            ids = self._translate(t_ids, idxs)
            outer.set_result((dists, ids))
            if t.shadow is not None and t.shadow.take():
                self._mirror(t, q, k, ids[None, :],
                             self.clock.now() - t0, {})

        inner.add_done_callback(_done)
        return outer

    def _mirror(self, t: Tenant, queries, k: int, live_ids, live_elapsed,
                topk_kw) -> None:
        """Run the mirrored query on the shadow view and fold the
        overlap + latency deltas into the arm and the registry. Shadow
        failures are recorded, never surfaced to the live path."""
        arm = t.shadow
        try:
            self._warm_shadow(t)
            t0 = self.clock.now()
            _, s_idxs = arm.engine.search(queries, k_top=k, **topk_kw)
            s_elapsed = self.clock.now() - t0
            s_ids = self._translate(arm.ids, s_idxs)
        except Exception as e:      # pragma: no cover - defensive
            self.registry.event("shadow_error", tenant=t.name,
                                error=repr(e))
            return
        live_ids = np.atleast_2d(np.asarray(live_ids))
        s_ids = np.atleast_2d(s_ids)
        for row in range(live_ids.shape[0]):
            a = set(int(i) for i in live_ids[row] if i >= 0)
            b = set(int(i) for i in s_ids[row] if i >= 0)
            arm.overlap_sum += len(a & b) / max(k, 1)
            arm.n_rows += 1
        arm.n_mirrored += 1
        arm.live_s += live_elapsed
        arm.shadow_s += s_elapsed
        self._c_mirrored.inc(tenant=t.name)
        st = arm.stats()
        self._g_overlap.set(st["overlap_at_k"], tenant=t.name)
        self._g_lat_ratio.set(st["latency_ratio"], tenant=t.name)

    # -- shadow lifecycle ----------------------------------------------------

    def register_shadow(self, name: str, L, *,
                        sample_rate: float = 0.25) -> ShadowArm:
        """Put a candidate L in shadow behind ``name``. One arm per
        tenant (re-registering replaces it). The arm's view builds lazily
        on the first mirrored query."""
        if not 0.0 < sample_rate <= 1.0:
            raise TenantError(f"sample_rate must be in (0, 1], got "
                              f"{sample_rate}")
        t = self.tenant(name)
        L = self._check_factor(L)
        with self._lock:
            t.shadow = ShadowArm(L, sample_rate)
        self.registry.event("shadow_register", tenant=name,
                            fingerprint=t.shadow.fingerprint,
                            sample_rate=sample_rate)
        return t.shadow

    def promote(self, name: str) -> Tenant:
        """Make the shadow arm live, atomically from the caller's view:
        the tenant's engine is repointed at the shadow's view (the same
        deterministic build a fresh router would produce — bit-identical
        answers), its LRU flushes on the identity change, the scheduler
        route re-derives its ladder, and the arm is cleared. The engine
        object survives, so held routes and ``engine.stats()`` readers
        stay valid."""
        t = self.tenant(name)
        with self._lock:
            arm = t.shadow
            if arm is None:
                raise TenantError(f"tenant {name!r} has no shadow arm")
            self._warm_shadow(t)    # build now if no traffic mirrored yet
            stats = arm.stats()
            t.L = arm.L
            t.fingerprint = arm.fingerprint
            if t.engine is None:
                # promoted before ever serving live: the arm's engine is
                # scoped "#shadow", and metric series cannot be renamed —
                # drop it and warm fresh under the live scope (same
                # deterministic build, so answers are identical anyway)
                t.shadow = None
                self.warm(name)     # RLock: safe under self._lock
                self._c_promotions.inc(tenant=name)
                return t
            t.engine.index = arm.engine.index   # identity change: flush
            t.ids = arm.ids
            t.built_generation = arm.built_generation
            t.shadow = None
            if self.scheduler is not None:
                self.scheduler.add_route(t.name, t.engine)
        self._c_promotions.inc(tenant=name)
        self.registry.event("tenant_promote", tenant=name,
                            fingerprint=t.fingerprint,
                            n_mirrored=stats["n_mirrored"],
                            overlap_at_k=stats["overlap_at_k"],
                            latency_ratio=stats["latency_ratio"])
        return t

    # -- scheduler ----------------------------------------------------------

    def attach_scheduler(self, scheduler) -> None:
        """Wire a RequestScheduler as the traffic front end: every warm
        tenant gets a route now; tenants warmed later register theirs at
        build time. Construct the scheduler with
        ``registry=router.registry`` so its frontend_* series stay
        unscoped on the shared base."""
        with self._lock:
            self.scheduler = scheduler
            for t in self._tenants.values():
                if t.engine is not None:
                    scheduler.add_route(t.name, t.engine)

    # -- accounting ----------------------------------------------------------

    def memory(self) -> dict:
        """Resident bytes: the shared raw store counted ONCE plus each
        warm view's index_memory total (the multi-tenant win: N tenants
        share one gallery instead of N raw copies)."""
        out = {"gallery": int(sum(b.nbytes for b in self._blocks)
                              + self._dead.nbytes),
               "tenants": {}, "shadows": {}}
        for name, t in self._tenants.items():
            if t.engine is not None:
                out["tenants"][name] = int(
                    sum(index_memory(t.engine.index).values()))
            if t.shadow is not None and t.shadow.engine is not None:
                out["shadows"][name] = int(
                    sum(index_memory(t.shadow.engine.index).values()))
        out["total"] = (out["gallery"] + sum(out["tenants"].values())
                        + sum(out["shadows"].values()))
        return out

    def observability(self) -> dict:
        """Router-level block for logs/benchmarks: gallery shape,
        per-tenant serving state (+ engine stats when warm, + shadow
        deltas when registered), and the byte accounting."""
        tenants = {}
        for name, t in self._tenants.items():
            block = {"warm": t.warm, "backend": t.backend,
                     "fingerprint": t.fingerprint,
                     "n_requests": t.n_requests,
                     "priority": t.priority,
                     "l_shape": list(t.L.shape)}
            if t.engine is not None:
                es = t.engine.stats()
                block.update(
                    view_rows=es["gallery_size"], qps=es["qps"],
                    cache_hits=es["cache_hits"],
                    cache_misses=es["cache_misses"],
                    stale=t.built_generation != self._generation)
            if t.shadow is not None:
                block["shadow"] = t.shadow.stats()
            tenants[name] = block
        return {"gallery_rows": self.gallery_rows,
                "live_rows": self.live_rows,
                "generation": self._generation,
                "d_in": self.d_in,
                "tenants": tenants,
                "memory": self.memory()}


# -- persistence -------------------------------------------------------------

def save_tenants(router: TenantRouter, out_dir: str) -> dict:
    """Persist a tenant set in the reference's format: the shared raw
    store once (gallery.npz), every tenant's factor (factors.npz), each
    warm *fresh* tenant's built view through ``save_index`` (tenant_<name>/
    with its own manifest + ids.npz), and tenants.json last (its presence
    marks the save complete). Stale views are persisted as cold —
    reloading rebuilds them, which is what staleness means. Returns the
    manifest dict."""
    os.makedirs(out_dir, exist_ok=True)
    stale = os.path.join(out_dir, TENANTS_MANIFEST)
    if os.path.isfile(stale):
        os.remove(stale)
    with router._lock:
        np.savez(os.path.join(out_dir, "gallery.npz"),
                 rows=router.rows(), dead=router._dead)
        np.savez(os.path.join(out_dir, "factors.npz"),
                 **{t.name: t.L for t in router._tenants.values()})
        manifest = {"format": 1, "k_top": router.k_top,
                    "generation": router._generation, "tenants": {}}
        for name, t in router._tenants.items():
            entry = {"backend": t.backend,
                     "build_kwargs": t.build_kwargs,
                     "k_top": t.k_top, "cache_size": t.cache_size,
                     "priority": t.priority, "deadline_s": t.deadline_s,
                     "fingerprint": t.fingerprint, "view": None}
            fresh = (t.engine is not None
                     and t.built_generation == router._generation)
            if fresh:
                sub = f"tenant_{name}"
                subdir = os.path.join(out_dir, sub)
                os.makedirs(subdir, exist_ok=True)
                # ids before save_index: the view manifest is the
                # completeness marker for the whole subdir
                np.savez(os.path.join(subdir, "ids.npz"), ids=t.ids)
                save_index(t.engine.index, subdir,
                           registry=router.registry)
                entry["view"] = sub
            manifest["tenants"][name] = entry
    path = os.path.join(out_dir, TENANTS_MANIFEST)
    with open(path + ".tmp", "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(path + ".tmp", path)
    router.registry.event("tenants_save", dir=out_dir,
                          n_tenants=len(manifest["tenants"]))
    return manifest


def load_tenants(snapshot_dir: str, *, device=None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Clock] = None) -> TenantRouter:
    """Reconstruct a ``save_tenants`` set (either package's) on ``device``
    (the card by default): shared store, every tenant's registration, and
    each persisted view attached WITHOUT re-projecting (the snapshot
    fingerprint is checked against the tenant's saved factor —
    ``TenantFingerprintError`` on mismatch, which means the snapshot
    directory was tampered with or mixed between saves)."""
    dev = resolve_device(device)
    path = os.path.join(snapshot_dir, TENANTS_MANIFEST)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no tenants manifest at {path} (incomplete or missing "
            f"save)")
    with open(path) as f:
        manifest = json.load(f)
    with np.load(os.path.join(snapshot_dir, "gallery.npz")) as z:
        rows, dead = z["rows"], z["dead"]
    with np.load(os.path.join(snapshot_dir, "factors.npz")) as z:
        factors = {k: z[k] for k in z.files}
    router = TenantRouter(rows, device=dev, registry=registry,
                          tracer=tracer, clock=clock,
                          k_top=int(manifest["k_top"]))
    router._dead = dead.astype(bool)
    router._generation = int(manifest["generation"])
    for name, entry in manifest["tenants"].items():
        t = router.add_tenant(
            name, factors[name], backend=entry["backend"],
            build_kwargs=entry["build_kwargs"], k_top=entry["k_top"],
            cache_size=entry["cache_size"], priority=entry["priority"],
            deadline_s=entry["deadline_s"])
        if t.fingerprint != entry["fingerprint"]:
            raise TenantFingerprintError(
                f"tenant {name!r}: saved factor fingerprints "
                f"{t.fingerprint}, manifest says "
                f"{entry['fingerprint']} — factors.npz and "
                f"tenants.json are from different saves")
        if entry["view"] is not None:
            attach_view(router, name,
                        os.path.join(snapshot_dir, entry["view"]))
    router.registry.event("tenants_load", dir=snapshot_dir,
                          n_tenants=len(manifest["tenants"]))
    return router


def attach_view(router: TenantRouter, name: str,
                view_dir: str) -> Tenant:
    """Attach a persisted view (a ``save_index`` directory + ids.npz) to
    a registered tenant without re-projecting, on the router's device.
    The view's manifest L fingerprint must match the tenant's factor — a
    mismatch raises ``TenantFingerprintError`` (the typed signal that the
    view was built under a different metric: rebuild or fix the factor
    instead)."""
    t = router.tenant(name)
    try:
        view = load_index(view_dir, expect_L=t.L, registry=router.registry,
                          device=router.device)
    except ValueError as e:
        raise TenantFingerprintError(
            f"tenant {name!r}: persisted view at {view_dir} was not "
            f"built under this tenant's factor: {e}") from e
    ids_path = os.path.join(view_dir, "ids.npz")
    if os.path.isfile(ids_path):
        with np.load(ids_path) as z:
            ids = z["ids"].astype(np.int64)
    else:                           # bare save_index dir: dense view
        ids = np.arange(view.size, dtype=np.int64)
    if ids.shape[0] != view.size:
        raise TenantError(
            f"tenant {name!r}: ids map has {ids.shape[0]} entries for a "
            f"{view.size}-row view at {view_dir}")
    with router._lock:
        router._attach_view(t, t.name, None, view, ids)
        if router.scheduler is not None:
            router.scheduler.add_route(t.name, t.engine)
    router._g_warm.set(1, tenant=name)
    return t
