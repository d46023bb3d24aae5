"""Traffic-shaped request front end: admission, deadlines, degradation.

Counterpart of ``repro/serve/scheduler.py``. The MicroBatcher coalesces
requests; this layer models *traffic*. It sits between clients and the
RetrievalEngine and owns the four serving behaviors an index alone
cannot provide:

  admission control   bounded per-class queues; a full queue rejects the
                      submit with a typed ``RejectedError`` immediately
                      (backpressure the client can act on) instead of
                      letting latency grow without bound;
  priority classes    each request belongs to a ``PriorityClass``
                      (``interactive`` / ``batch`` / ``mining`` by
                      default); batches are formed highest-priority-first,
                      FIFO within a class, so cheap interactive lookups
                      are never stuck behind a deep mining sweep;
  deadlines           every request carries an absolute deadline; one that
                      expires while queued fails fast with
                      ``DeadlineExceededError`` and never occupies a batch
                      slot or touches the engine;
  adaptive degradation a ``LoadController`` watches queue depth and steps
                      a quality ladder — per-level ``index.topk`` knob
                      overrides (``nprobe``, ``rerank``) — down under
                      sustained pressure and back up when it drains,
                      spending less compute per query exactly when the
                      queue says the budget is tight. Every transition is
                      recorded with its trigger.

All time — request expiry, batch-formation waits, degradation windows —
flows through the injectable ``Clock`` (serve/clock.py), so the entire
front end runs deterministically under ``FakeClock`` in tests: no sleeps,
no timing races. The worker threads and the clock are plain Python; only
the engine call reaches the card (the ``metric_topk`` / ``ivf_scan`` /
``pq_adc`` kernel of the engine's index, at the knobs of the batch's
ladder level).

Threading model: ``submit`` may be called from any number of client
threads; ``n_workers`` worker threads form batches and feed the engine
under one engine lock (the engine itself is single-caller by contract).
Futures resolve exactly once — result, typed rejection, or client
cancellation — guarded by ``set_running_or_notify_cancel``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.engine import RetrievalEngine


# -- typed request outcomes --------------------------------------------------

class SchedulerError(Exception):
    """Base for every typed front-end failure."""


class RejectedError(SchedulerError):
    """Admission refused: class queue at capacity, or scheduler closed."""


class DeadlineExceededError(SchedulerError):
    """The request's deadline passed while it waited in the queue."""


# -- priority classes --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One traffic class: who goes first, how long they may wait, and how
    many of them may queue.

    priority: lower numbers are served first (strict: a batch never takes
      a lower-priority request while a higher-priority one is admissible).
    deadline_s: default per-request deadline (submit may override).
    queue_cap: bounded admission queue; submits beyond it are rejected.
    """
    name: str
    priority: int
    deadline_s: float
    queue_cap: int


DEFAULT_CLASSES: Tuple[PriorityClass, ...] = (
    PriorityClass("interactive", priority=0, deadline_s=0.100,
                  queue_cap=256),
    PriorityClass("batch", priority=1, deadline_s=1.0, queue_cap=1024),
    PriorityClass("mining", priority=2, deadline_s=10.0, queue_cap=4096),
)


# -- per-class latency/counter stats -----------------------------------------

class LatencyWindow:
    """Bounded window of latency samples with percentile readout.

    Thread-safe: ``record`` may race with ``percentile``/``snapshot``
    (the lock makes each a consistent atomic snapshot). The window keeps
    the most recent ``maxlen`` samples — a long-lived server reports
    recent tail behavior, not its lifetime average.
    """

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(maxlen=maxlen)

    def record(self, value: float) -> None:
        with self._lock:
            self._samples.append(float(value))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentile(self, q) -> float:
        """obs.percentile (linear interpolation, as np.percentile) over
        the current window; NaN when empty. ``q`` may be a scalar or a
        sequence. This used to be one of three ad-hoc percentile
        implementations; all of them now route through obs."""
        with self._lock:
            samples = list(self._samples)
        return obs_metrics.percentile(samples, q)


_OUTCOMES = ("admitted", "rejected", "expired", "completed", "failed",
             "cancelled")


class _ClassStats:
    """Per-priority-class counters + latency, re-homed onto the stack's
    MetricsRegistry: ``frontend_requests_total{class,outcome}`` and the
    ``frontend_latency_seconds{class}`` histogram. Increments are atomic
    under the registry lock; the windowed percentile readout stays local
    (recent tail, not lifetime) via LatencyWindow."""

    def __init__(self, name: str, registry: obs_metrics.MetricsRegistry):
        self.name = name
        self._c = registry.counter(
            "frontend_requests_total",
            "front-end requests by priority class and outcome "
            "(admitted counts entry; the others are terminal)",
            labelnames=("cls", "outcome"))
        self._h = registry.histogram(
            "frontend_latency_seconds",
            "submit-to-resolve latency of completed requests",
            labelnames=("cls",))
        self.latency = LatencyWindow()

    def bump(self, field: str, by: int = 1) -> None:
        if field not in _OUTCOMES:
            raise ValueError(f"unknown outcome {field!r}")
        self._c.inc(by, cls=self.name, outcome=field)

    def record_latency(self, seconds: float) -> None:
        self.latency.record(seconds)
        self._h.observe(seconds, cls=self.name)

    def __getattr__(self, field):
        # back-compat reads (st.admitted, st.completed, ...) resolve to
        # the registry counter; only reached when not a real attribute
        if field in _OUTCOMES:
            return int(self._c.value(cls=self.name, outcome=field))
        raise AttributeError(field)

    def snapshot(self) -> dict:
        out = {f: int(self._c.value(cls=self.name, outcome=f))
               for f in _OUTCOMES}
        p50, p99 = self.latency.percentile((50.0, 99.0))
        out["p50_ms"] = p50 * 1e3
        out["p99_ms"] = p99 * 1e3
        return out


# -- adaptive degradation ----------------------------------------------------

def default_ladder(index, k_top: int, n_levels: int = 3) -> Tuple[dict, ...]:
    """Derive a quality ladder from the index's own knobs.

    Level 0 is always ``{}`` (build-time quality). For PQ bases the first
    rung shrinks only the exact-rerank pool (``rerank`` halved, floored at
    ``k_top`` — IVFPQ clamps there anyway, and MutableIndex rejects
    ``rerank=0``): the rerank gather is the cheapest lever, and cutting
    it leaves the ADC candidate scan untouched, so recall dips least per
    unit of saved compute. Each deeper level then halves ``nprobe``
    (floored so ``k_top`` still fits in the scanned candidate pool)
    together with the rerank pool. Indexes with no knobs (ExactIndex)
    get the single full-quality level: the controller then has nothing
    to trade, and admission control alone carries overload.
    """
    base = getattr(index, "base", index)       # MutableIndex wraps
    nprobe = getattr(base, "nprobe", None)
    if nprobe is None:
        return ({},)
    cap = base.cap
    nprobe_floor = max(1, -(-k_top // cap))    # ceil(k_top / cap)
    rerank = getattr(base, "rerank_depth", None)
    ladder = [{}]
    if rerank:                                 # 0 = ADC-only build: leave
        knobs = {"rerank": max(k_top, rerank >> 1)}
        if knobs["rerank"] < rerank:           # already at the floor: skip
            ladder.append(knobs)
    for step in range(1, n_levels):
        knobs = {"nprobe": max(nprobe_floor, nprobe >> step)}
        if rerank:
            knobs["rerank"] = max(k_top, rerank >> step)
        if ladder[-1] != knobs:                # stop once floored flat
            ladder.append(knobs)
    return tuple(ladder)


@dataclasses.dataclass(frozen=True)
class DegradeTransition:
    """One recorded ladder move (t is clock time at the decision)."""
    t: float
    level_from: int
    level_to: int
    queue_depth: int
    reason: str


class LoadController:
    """Queue-pressure feedback loop over a quality ladder.

    The worker calls ``observe(queue_depth)`` before forming each batch;
    sustained depth above ``high_watermark`` for ``degrade_window_s``
    steps one ladder level down (cheaper queries), sustained depth at or
    below ``low_watermark`` for ``restore_window_s`` steps back up.
    Windows are measured on the injected clock, so hysteresis is
    deterministic under FakeClock. Single-caller (the worker holding the
    scheduler lock); readers see ``level`` / ``transitions`` atomically
    under the GIL.
    """

    def __init__(self, ladder: Sequence[dict], clock: Clock,
                 high_watermark: int = 32, low_watermark: int = 4,
                 degrade_window_s: float = 0.05,
                 restore_window_s: float = 0.5):
        if not ladder or ladder[0] != {}:
            raise ValueError("ladder[0] must be {} (full quality)")
        if low_watermark >= high_watermark:
            raise ValueError(f"low_watermark={low_watermark} must be < "
                             f"high_watermark={high_watermark}")
        self.ladder = tuple(dict(lv) for lv in ladder)
        self.clock = clock
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.degrade_window_s = degrade_window_s
        self.restore_window_s = restore_window_s
        self.level = 0
        self.transitions: list = []
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None

    def _move(self, to: int, depth: int, reason: str) -> None:
        self.transitions.append(DegradeTransition(
            self.clock.now(), self.level, to, depth, reason))
        self.level = to
        self._over_since = None
        self._under_since = None

    def observe(self, queue_depth: int) -> dict:
        """Update pressure windows, maybe move a level, and return the
        knob overrides to serve the next batch with."""
        now = self.clock.now()
        if queue_depth > self.high_watermark:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            elif (now - self._over_since >= self.degrade_window_s
                  and self.level < len(self.ladder) - 1):
                self._move(self.level + 1, queue_depth,
                           f"depth {queue_depth} > {self.high_watermark} "
                           f"for {self.degrade_window_s}s")
        elif queue_depth <= self.low_watermark:
            self._over_since = None
            if self._under_since is None:
                self._under_since = now
            elif (now - self._under_since >= self.restore_window_s
                  and self.level > 0):
                self._move(self.level - 1, queue_depth,
                           f"depth {queue_depth} <= {self.low_watermark} "
                           f"for {self.restore_window_s}s")
        else:                       # between watermarks: hold the level
            self._over_since = None
            self._under_since = None
        return self.ladder[self.level]


# -- the scheduler -----------------------------------------------------------

@dataclasses.dataclass
class _Request:
    q: np.ndarray
    k: int
    fut: Future
    cls: PriorityClass
    t_submit: float
    t_deadline: float
    trace: object = None        # obs.Trace minted at submit (or None)
    q_span: object = None       # open "queue" span, ended at dequeue
    route: object = None        # tenant route name (None = default engine)


_ANY_ROUTE = object()           # _pop_live_locked sentinel: no route filter


class RequestScheduler:
    """Async request front end over a RetrievalEngine (module docstring
    has the model). Construct, ``submit`` from any thread, ``close`` when
    done; attach-time side effect: ``engine.frontend = self`` so
    ``engine.stats()`` grows the front-end observability block.
    """

    def __init__(self, engine: RetrievalEngine,
                 classes: Sequence[PriorityClass] = DEFAULT_CLASSES,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 n_workers: int = 1, clock: Optional[Clock] = None,
                 degrade: bool = True,
                 ladder: Optional[Sequence[dict]] = None,
                 high_watermark: int = 32, low_watermark: int = 4,
                 degrade_window_s: float = 0.05,
                 restore_window_s: float = 0.5,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.clock = clock if clock is not None else SystemClock()
        # share the engine's registry/tracer when it has them (the real
        # RetrievalEngine always does), so the whole stack records into
        # one instance; a bare test double gets a private registry. An
        # explicit ``registry`` overrides — a multi-tenant front end
        # (serve/tenant.py) serves tenant-scoped engines but its own
        # frontend_* metrics belong on the unscoped base registry.
        reg = (registry if registry is not None
               else getattr(engine, "registry", None))
        self.registry = (reg if reg is not None
                         else obs_metrics.MetricsRegistry(clock=self.clock))
        self.tracer = getattr(engine, "tracer", None)
        # strict priority: queues iterated in ascending priority order
        self._classes: Dict[str, PriorityClass] = {
            c.name: c for c in sorted(classes, key=lambda c: c.priority)}
        self._queues: Dict[str, collections.deque] = {
            name: collections.deque() for name in self._classes}
        self._stats: Dict[str, _ClassStats] = {
            name: _ClassStats(name, self.registry)
            for name in self._classes}
        self._cond = threading.Condition()
        self._closed = False
        self._c_batches = self.registry.counter(
            "frontend_batches_total", "batches dispatched to the engine")
        self._h_batch = self.registry.histogram(
            "frontend_batch_size", "live requests per dispatched batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._g_depth = self.registry.gauge(
            "frontend_queue_depth", "requests waiting, by priority class",
            labelnames=("cls",))
        self._g_level = self.registry.gauge(
            "frontend_degradation_level",
            "current quality-ladder level (0 = full quality)")
        self._c_tenant = self.registry.counter(
            "frontend_tenant_requests_total",
            "front-end requests by tenant route and outcome",
            labelnames=("tenant", "outcome"))
        self.registry.register_collector(self._collect_gauges)
        self.batch_sizes: collections.deque = collections.deque(maxlen=4096)
        # tenant routes: name -> (engine, per-route LoadController). A
        # routed submit validates and serves against its route's engine;
        # batches never mix routes (one engine call per batch).
        self._routes: Dict[object, tuple] = {}
        self._ctrl_kw = dict(high_watermark=high_watermark,
                             low_watermark=low_watermark,
                             degrade_window_s=degrade_window_s,
                             restore_window_s=restore_window_s)
        self._degrade = degrade
        if degrade:
            lad = (tuple(ladder) if ladder is not None
                   else default_ladder(engine.index, engine.k_top))
            self.controller: Optional[LoadController] = LoadController(
                lad, self.clock, high_watermark=high_watermark,
                low_watermark=low_watermark,
                degrade_window_s=degrade_window_s,
                restore_window_s=restore_window_s)
        else:
            self.controller = None
        # engine calls are serialized: the engine contract is one caller
        # at a time (stats counters, LRU) — extra workers overlap only on
        # host-side batch formation and future resolution
        self._engine_lock = threading.Lock()
        engine.frontend = self
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"scheduler-worker-{i}")
            for i in range(n_workers)]
        for t in self._threads:
            t.start()

    def _collect_gauges(self):
        """Snapshot-time gauges: per-class queue depth + ladder level
        (the ROADMAP's dashboard gauges). No-ops once another scheduler
        has attached to the same engine — collectors registered on a
        shared registry outlive this front end."""
        if self.engine.frontend is not self:
            return
        with self._cond:
            depths = {name: len(q) for name, q in self._queues.items()}
        for name, depth in depths.items():
            self._g_depth.set(depth, cls=name)
        ctrl = self.controller
        self._g_level.set(0 if ctrl is None else ctrl.level)

    @property
    def n_batches(self) -> int:
        return int(self._c_batches.value())

    # -- tenant routes -------------------------------------------------------

    def add_route(self, name: str, engine: RetrievalEngine,
                  ladder: Optional[Sequence[dict]] = None) -> None:
        """Register a tenant route: submits with ``route=name`` validate
        against and are served by ``engine``, under a per-route quality
        ladder (derived from the route engine's own index unless given).
        Re-registering a name repoints it (the tenant router does this
        after a promotion rebuilds a view)."""
        ctrl = None
        if self._degrade:
            lad = (tuple(ladder) if ladder is not None
                   else default_ladder(engine.index, engine.k_top))
            ctrl = LoadController(lad, self.clock, **self._ctrl_kw)
        with self._cond:
            self._routes[name] = (engine, ctrl)

    def routes(self) -> tuple:
        with self._cond:
            return tuple(self._routes)

    def _resolve_route(self, route):
        """(engine, controller) serving ``route`` (None = the default)."""
        if route is None:
            return self.engine, self.controller
        with self._cond:
            entry = self._routes.get(route)
        if entry is None:
            raise ValueError(f"unknown route {route!r} "
                             f"(have {sorted(map(str, self._routes))})")
        return entry

    def _settle(self, r: _Request, outcome: str) -> None:
        """Terminal bookkeeping for one request: class counters, the
        per-tenant outcome counter (routed requests only), and trace
        close — every resolution path funnels here."""
        self._stats[r.cls.name].bump(outcome)
        if r.route is not None:
            self._c_tenant.inc(tenant=str(r.route), outcome=outcome)
        self._finish_trace(r, outcome)

    def _finish_trace(self, r: _Request, outcome: str) -> None:
        """Close a request's trace (no-op for untraced requests): end the
        queue span if still open, stamp the outcome, hand the tree to the
        tracer."""
        if r.trace is None:
            return
        r.q_span.end()
        r.trace.root.set_attrs(outcome=outcome)
        self.tracer.finish(r.trace)

    # -- client side --------------------------------------------------------

    def submit(self, query, k_top: Optional[int] = None,
               priority: str = "interactive",
               deadline_s: Optional[float] = None,
               route: Optional[str] = None) -> Future:
        """Enqueue one (d,) query under a priority class.

        Returns a Future resolving to (dists (k,), ids (k,)). Admission
        failures raise ``RejectedError`` *here* — a rejected request
        never holds a queue slot. An admitted request always resolves:
        result, ``DeadlineExceededError``, engine exception, or client
        cancellation. ``deadline_s`` overrides the class default
        (relative to now; must be > 0). ``route`` targets a tenant route
        registered with ``add_route`` (validation and service happen
        against that route's engine; batches never mix routes).
        """
        cls = self._classes.get(priority)
        if cls is None:
            raise ValueError(f"unknown priority class {priority!r} "
                             f"(have {list(self._classes)})")
        engine, _ = self._resolve_route(route)
        k = engine.k_top if k_top is None else k_top
        if k < 1:
            raise ValueError(f"k_top must be >= 1, got {k}")
        if k > engine.k_top:
            raise ValueError(f"k_top={k} > engine k_top="
                             f"{engine.k_top}")
        dl = cls.deadline_s if deadline_s is None else deadline_s
        if dl <= 0:
            raise ValueError(f"deadline_s must be > 0, got {dl}")
        q = np.asarray(query, np.float32)
        d = engine.index.L.shape[1]
        if q.shape != (d,):     # reject here, not in the shared worker
            raise ValueError(f"query shape {q.shape} != ({d},)")
        st = self._stats[cls.name]
        with self._cond:
            if self._closed:
                st.bump("rejected")
                raise RejectedError("scheduler is closed")
            queue = self._queues[cls.name]
            if len(queue) >= cls.queue_cap:
                st.bump("rejected")
                raise RejectedError(
                    f"{cls.name} queue full ({cls.queue_cap}); retry "
                    f"with backoff or shed load upstream")
            now = self.clock.now()
            fut: Future = Future()
            r = _Request(q, k, fut, cls, now, now + dl, route=route)
            if self.tracer is not None and self.tracer.sample_rate > 0:
                # the trace id is minted here, at admission; the "queue"
                # span stays open until a worker dequeues the request
                r.trace = self.tracer.start_trace("request")
                r.trace.root.set_attrs(cls=cls.name, k=k)
                if route is not None:
                    r.trace.root.set_attrs(tenant=str(route))
                r.q_span = r.trace.span("queue")
            queue.append(r)
            st.bump("admitted")
            if route is not None:
                self._c_tenant.inc(tenant=str(route), outcome="admitted")
            self._cond.notify_all()
        return fut

    def close(self, timeout: float = 10.0, drain: bool = True) -> bool:
        """Stop the workers. ``drain=True`` serves already-admitted
        requests first; ``drain=False`` fails them fast with
        ``RejectedError``. Returns True when every worker exited within
        ``timeout`` real seconds (False = at least one still alive, same
        contract as ``MicroBatcher.close``)."""
        with self._cond:
            self._closed = True
            if not drain:
                for name, queue in self._queues.items():
                    while queue:
                        r = queue.popleft()
                        if r.fut.set_running_or_notify_cancel():
                            r.fut.set_exception(
                                RejectedError("scheduler closed before "
                                              "the request was served"))
                            self._settle(r, "rejected")
                        else:
                            self._settle(r, "cancelled")
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        return not any(t.is_alive() for t in self._threads)

    # -- worker side --------------------------------------------------------

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _pop_live_locked(self, route=_ANY_ROUTE) -> Optional[_Request]:
        """Pop the highest-priority non-expired request, failing expired
        ones fast (typed error; they never occupy a batch slot). With a
        ``route`` filter, only requests of that route are considered —
        others stay queued in place (their FIFO position is preserved;
        their deadlines are judged when they are actually popped)."""
        now = self.clock.now()
        for name, queue in self._queues.items():   # ascending priority
            i = 0
            while i < len(queue):
                r = queue[i]
                if route is not _ANY_ROUTE and r.route != route:
                    i += 1
                    continue
                del queue[i]
                if r.fut.cancelled():   # client walked away while queued
                    self._settle(r, "cancelled")
                    continue
                if r.t_deadline <= now:
                    if r.fut.set_running_or_notify_cancel():
                        r.fut.set_exception(DeadlineExceededError(
                            f"{name} deadline "
                            f"{r.t_deadline - r.t_submit:.3f}s expired "
                            f"in queue"))
                        self._settle(r, "expired")
                    else:
                        self._settle(r, "cancelled")
                    continue
                return r
        return None

    def _collect(self) -> Optional[list]:
        """Form one batch: highest-priority-first, FIFO within a class,
        waiting at most ``max_wait_s`` past the first member — and never
        past any collected member's deadline (deadline-aware formation:
        idling a member into expiry would waste its admission). The first
        member fixes the batch's route: one batch is one engine call, so
        riders must share its engine."""
        with self._cond:
            batch: list = []
            while not batch:
                r = self._pop_live_locked()
                if r is not None:
                    batch.append(r)
                    break
                if self._closed:
                    return None
                self.clock.wait_on(self._cond, None)
            route = batch[0].route
            wait_until = self.clock.now() + self.max_wait_s
            while len(batch) < self.max_batch:
                r = self._pop_live_locked(route)
                if r is not None:
                    batch.append(r)
                    continue
                if self._closed:            # nothing more is coming
                    break
                bound = min(wait_until,
                            min(m.t_deadline for m in batch))
                remaining = bound - self.clock.now()
                if remaining <= 0:
                    break
                self.clock.wait_on(self._cond, remaining)
            return batch

    def _loop(self):
        while True:
            batch = self._collect()
            if batch:
                self._run_batch(batch)
            with self._cond:
                if self._closed and self._depth_locked() == 0:
                    return

    def _run_batch(self, batch):
        # claim every member exactly once before dispatch: a cancelled
        # rider drops out here (it must not reach the engine), an expired
        # one fails fast, and survivors are RUNNING — no InvalidStateError
        # window between resolution paths
        now = self.clock.now()
        live = []
        for r in batch:
            if not r.fut.set_running_or_notify_cancel():
                self._settle(r, "cancelled")
            elif r.t_deadline <= now:   # expired during batch formation
                r.fut.set_exception(DeadlineExceededError(
                    f"{r.cls.name} deadline expired during batch "
                    f"formation"))
                self._settle(r, "expired")
            else:
                if r.q_span is not None:
                    r.q_span.end()      # dequeued: queue wait is over
                live.append(r)
        if not live:
            return
        # routed batches serve their route's engine under its own quality
        # ladder (_collect guarantees one route per batch); pressure is
        # still judged on the TOTAL queue depth — one worker drains every
        # route, so the backlog any route sees is the shared one
        engine, controller = self._resolve_route(live[0].route)
        if controller is not None:
            with self._cond:
                depth = self._depth_locked()
            knobs = controller.observe(depth)
        else:
            knobs = {}
        # one batch serves many requests but the engine takes one span:
        # the first *sampled* rider carries the batch + engine detail
        # (other sampled riders in the same batch keep their queue span
        # and outcome, without the shared-stage duplication)
        carrier = next((r for r in live
                        if r.trace is not None and r.trace.sampled), None)
        b_span = e_span = None
        if carrier is not None:
            b_span = carrier.trace.span("batch").set_attrs(
                size=len(live), level=(0 if controller is None
                                       else controller.level),
                **{f"knob_{k}": v for k, v in knobs.items()})
            if live[0].route is not None:
                b_span.set_attrs(tenant=str(live[0].route))
            e_span = carrier.trace.span("engine", parent=b_span)
        try:
            qs = np.stack([r.q for r in live])
            with self._engine_lock:
                if e_span is not None:
                    dists, idxs = engine.search(qs, span=e_span,
                                                **knobs)
                else:
                    dists, idxs = engine.search(qs, **knobs)
        except Exception as e:          # fail every rider, keep serving
            if b_span is not None:
                e_span.set_attrs(error=repr(e)).end()
                b_span.end()
            for r in live:              # already RUNNING: resolve directly
                r.fut.set_exception(e)
                self._settle(r, "failed")
            return
        if b_span is not None:
            e_span.end()
            b_span.end()
        self._c_batches.inc()
        self._h_batch.observe(len(live))
        self.batch_sizes.append(len(live))
        done = self.clock.now()
        for row, r in enumerate(live):
            st = self._stats[r.cls.name]
            r.fut.set_result((dists[row, :r.k], idxs[row, :r.k]))
            st.record_latency(done - r.t_submit)
            self._settle(r, "completed")

    # -- warmup / observability ---------------------------------------------

    def warmup(self, ks: Optional[Sequence[int]] = None) -> None:
        """Run every (bucket, k) at every ladder level up front, so the
        first degraded batch pays no first-launch cost exactly when the
        system is already overloaded. One synchronisation at the end."""
        self.engine.warmup(ks=ks)                  # level 0
        if self.controller is None:
            return
        ks = (self.engine.k_top,) if ks is None else tuple(ks)
        d = self.engine.index.L.shape[1]
        dev = self.engine.device
        for knobs in self.controller.ladder[1:]:
            for k in ks:
                for b in self.engine.buckets:
                    self.engine.index.topk(
                        torch.zeros((b, d), dtype=torch.float32,
                                    device=dev), k, **knobs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def observability(self) -> dict:
        """The front-end block ``engine.stats()`` embeds: per-class
        counters + latency percentiles + queue depths, plus the
        degradation state. Safe to call from any thread (class counters
        lock per class; queue depths snapshot under the scheduler lock)."""
        with self._cond:
            depths = {name: len(q) for name, q in self._queues.items()}
            closed = self._closed
        classes = {}
        for name, st in self._stats.items():
            snap = st.snapshot()
            snap["queue_depth"] = depths[name]
            classes[name] = snap
        ctrl = self.controller
        out = {
            "classes": classes,
            "queue_depth": sum(depths.values()),
            "rejections": sum(c["rejected"] for c in classes.values()),
            "expired": sum(c["expired"] for c in classes.values()),
            "n_batches": self.n_batches,
            "closed": closed,
            "degradation_level": 0 if ctrl is None else ctrl.level,
            "degradation_knobs": ({} if ctrl is None
                                  else dict(ctrl.ladder[ctrl.level])),
            "n_transitions": (0 if ctrl is None
                              else len(ctrl.transitions)),
        }
        tenants: Dict[str, Dict[str, int]] = {}
        for key in self._c_tenant.label_keys():
            labels = dict(obs_metrics.parse_label_key(key))
            per = tenants.setdefault(labels["tenant"], {})
            per[labels["outcome"]] = int(self._c_tenant.value(**labels))
        if tenants:
            out["tenants"] = tenants
        return out

    stats = observability
