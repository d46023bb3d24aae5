"""Unified metrics registry: one place every subsystem's counters live.

Before this module, seven subsystems each grew a private ``stats()``
dict and three of them hand-rolled their own latency percentiles. The
paper's headline claims are *systems* claims (1M points, 200M pairs, 15
hours on 256 cores) — staleness, per-stage throughput, and queue
behavior are quantities that must be measured, not assumed — so the
measurement layer is a subsystem of its own:

  ``MetricsRegistry``   thread-safe, labeled ``Counter`` / ``Gauge`` /
                        ``Histogram`` instruments keyed by stable
                        documented names (docs/observability.md is the
                        catalog), plus a bounded structured-event log
                        for rare lifecycle transitions (compaction,
                        snapshot load, metric swap);
  snapshots             ``registry.snapshot()`` freezes every instrument
                        into a nested plain dict (JSON-safe), and
                        ``merge_snapshots`` combines two — counters and
                        histograms add, gauges take the later value —
                        so per-process registries roll up to one view;
  exposition            ``registry.exposition()`` renders the
                        Prometheus text format for dashboard scrapes;
  ``percentile``        THE latency-percentile implementation. Three
                        ad-hoc copies existed (scheduler.LatencyWindow,
                        serve_retrieval, serving_load) and one of them
                        underflowed to the *minimum* at small n
                        (``lat[int(n * 0.99) - 1]`` is ``lat[0]`` for
                        n=2); everything now routes here.

The registry never imports jax or the serving stack: it accepts any
object with a ``.now() -> float`` method as its clock (serve/clock.py's
``Clock`` satisfies it; the default reads ``time.monotonic``), so the
obs layer sits below every other subsystem without import cycles, and
FakeClock drives event timestamps and histogram tests deterministically.

Thread-safety: one lock per registry serializes every mutation
(``inc``/``set``/``observe``/``event``) and every read, so concurrent
writers never lose an increment — the engine's cache counters used to
be racy read-modify-writes from batcher and scheduler threads; through
the registry they are exact.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple


class _MonotonicClock:
    """Default time source (duck-typed ``Clock``): real monotonic time."""

    def now(self) -> float:
        return time.monotonic()


def percentile(values, q):
    """The one percentile implementation (linear interpolation, as
    ``np.percentile``). ``values`` is any sequence of samples; ``q`` a
    scalar or sequence of percentiles in [0, 100]. Empty input returns
    NaN (scalar q) or a list of NaNs.

    Small-n behavior (the class of bug this replaces): n=1 returns that
    sample for every q; n=2 returns the interpolation between the two —
    never the *minimum* for a high percentile, which is what
    ``sorted_values[int(n * 0.99) - 1]`` silently produced.
    """
    import numpy as np

    scalar = np.isscalar(q)
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        return float("nan") if scalar else [float("nan")] * len(q)
    out = np.percentile(vals, q)
    return float(out) if scalar else [float(v) for v in out]


def log_buckets(lo: float = 1e-4, hi: float = 60.0,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds covering [lo, hi]
    (inclusive), ``per_decade`` bounds per decade. The default spans
    0.1 ms .. 60 s — the serving latency range — in 18 buckets; a
    trailing +inf bucket is implicit in every Histogram.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = int(round(math.log10(hi / lo) * per_decade))
    bounds = [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]
    if bounds[-1] < hi * (1 - 1e-12):
        bounds.append(hi)
    return tuple(round(b, 12) for b in bounds)


DEFAULT_LATENCY_BUCKETS = log_buckets()

_RESERVED = ("le", "quantile")


def _label_key(labelnames: Tuple[str, ...], labels: dict) -> str:
    """Canonical string key for one labelset: "a=x,b=y" (sorted by the
    declared label order), "" when unlabeled. Keys are JSON-object-safe
    so snapshots nest as plain dicts."""
    if set(labels) != set(labelnames):
        raise ValueError(f"labels {sorted(labels)} != declared "
                         f"{sorted(labelnames)}")
    return ",".join(f"{k}={labels[k]}" for k in labelnames)


def parse_label_key(key: str) -> Dict[str, str]:
    """Inverse of the snapshot label key: "a=x,b=y" -> dict."""
    if not key:
        return {}
    return dict(part.split("=", 1) for part in key.split(","))


class _Metric:
    """Shared name/labels plumbing; subclasses own the value shape."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.RLock):
        if not name or any(c in name for c in " {}\",\n"):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if ln in _RESERVED:
                raise ValueError(f"label name {ln!r} is reserved")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: dict = {}

    def _key(self, labels: dict) -> str:
        return _label_key(self.labelnames, labels)

    def label_keys(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._values)


class Counter(_Metric):
    """Monotone float counter. ``inc`` is atomic under the registry
    lock — concurrent threads never lose an increment."""

    kind = "counter"

    def inc(self, by: float = 1.0, **labels) -> None:
        if by < 0:
            raise ValueError(f"counters only go up (by={by})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum across every labelset (e.g. all classes, all outcomes)."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    """Point-in-time value (queue depth, ladder level, resident bytes)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, by: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Bucketed distribution with log-spaced default latency buckets.

    Per labelset the histogram keeps ``len(buckets) + 1`` non-cumulative
    bucket counts (the last is the +inf overflow), the sample sum, and
    the sample count. ``observe`` uses ``bisect`` over the upper bounds:
    a value lands in the first bucket whose bound is >= value, exactly —
    tests assert bucket contents with ``==``, not approx.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames, lock)
        b = tuple(float(x) for x in
                  (DEFAULT_LATENCY_BUCKETS if buckets is None else buckets))
        if not b or list(b) != sorted(set(b)):
            raise ValueError(f"buckets must be ascending+unique, got {b}")
        if math.isinf(b[-1]):
            b = b[:-1]          # +inf bucket is always implicit
        self.buckets = b

    def _cell(self, key):
        cell = self._values.get(key)
        if cell is None:
            cell = self._values[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0}
        return cell

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        i = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            cell = self._cell(key)
            cell["counts"][i] += 1
            cell["sum"] += float(value)
            cell["count"] += 1

    def counts(self, **labels):
        """Non-cumulative per-bucket counts (len(buckets) + 1)."""
        with self._lock:
            cell = self._values.get(self._key(labels))
            return (list(cell["counts"]) if cell
                    else [0] * (len(self.buckets) + 1))

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._values.get(self._key(labels))
            return cell["count"] if cell else 0

    def sum(self, **labels) -> float:
        with self._lock:
            cell = self._values.get(self._key(labels))
            return cell["sum"] if cell else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Upper-bound estimate of the q-th percentile from bucket
        counts (the bound of the bucket holding the q-th sample; inf if
        it landed in the overflow bucket, NaN when empty). This is the
        report-time readout — exact percentiles come from raw windows
        (``obs.percentile``); the histogram trades that for mergeable
        fixed-size state."""
        counts = self.counts(**labels)
        total = int(builtins_sum(counts))
        if total == 0:
            return float("nan")
        rank = q / 100.0 * total
        run = 0
        for i, c in enumerate(counts):
            run += c
            if run >= rank and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")


builtins_sum = sum      # Histogram.sum shadows the builtin in-class


class MetricsRegistry:
    """Get-or-create instrument registry + structured-event log.

    One registry spans the whole serving/training stack: the engine
    creates (or receives) one, and every layer that attaches to the
    engine — scheduler, batcher, mutable index, miner, closed loop —
    records into the same instance, so one ``snapshot()`` is the whole
    system's state. ``counter``/``gauge``/``histogram`` are idempotent:
    a second call with the same name returns the same instrument
    (mismatched kind/labels/buckets raise — name collisions are bugs).

    Collectors: ``register_collector(fn)`` adds a zero-arg callable run
    at the top of every ``snapshot()``/``exposition()`` — the hook for
    gauges derived from live state (queue depths, resident bytes) that
    would be stale if only pushed on mutation.
    """

    def __init__(self, clock=None, max_events: int = 1024):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: list = []
        self._events: list = []
        self._max_events = max_events
        self.clock = clock if clock is not None else _MonotonicClock()

    # -- instruments ---------------------------------------------------------

    def _get(self, cls, name, help, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames,
                                              self._lock, **kw)
                return m
        if not isinstance(m, cls):
            raise ValueError(f"{name!r} already registered as {m.kind}")
        if m.labelnames != labelnames:
            raise ValueError(f"{name!r} labelnames {m.labelnames} != "
                             f"{labelnames}")
        if kw.get("buckets") is not None and tuple(
                float(b) for b in kw["buckets"]) != m.buckets:
            raise ValueError(f"{name!r} re-registered with different "
                             f"buckets")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets)

    def register_collector(self, fn) -> None:
        with self._lock:
            self._collectors.append(fn)

    def scoped(self, **bound) -> "ScopedRegistry":
        """A write view of this registry with label values pre-bound
        (``registry.scoped(tenant="a")``) — see ScopedRegistry below."""
        return ScopedRegistry(self, **bound)

    # -- structured events ---------------------------------------------------

    def event(self, name: str, **attrs) -> None:
        """Append one structured lifecycle event (bounded: oldest events
        drop past ``max_events``). For rare transitions — compactions,
        snapshot save/load, metric swaps — not per-request traffic."""
        rec = {"t": self.clock.now(), "event": name, **attrs}
        with self._lock:
            self._events.append(rec)
            if len(self._events) > self._max_events:
                del self._events[:len(self._events) - self._max_events]

    def events(self, name: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e["event"] == name]

    # -- export --------------------------------------------------------------

    def _collect(self):
        for fn in list(self._collectors):
            fn()

    def snapshot(self) -> dict:
        """Freeze every instrument into a nested JSON-safe dict:

        ``{"t", "counters": {name: {"help", "labels", "values":
        {label_key: v}}}, "gauges": {...}, "histograms": {name: {...,
        "buckets", "values": {label_key: {"counts", "sum", "count"}}}},
        "events": [...]}``. Collectors run first, so derived gauges are
        current."""
        self._collect()
        with self._lock:
            out = {"t": self.clock.now(), "counters": {}, "gauges": {},
                   "histograms": {}, "events": [dict(e) for e in
                                                self._events]}
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Histogram):
                    out["histograms"][name] = {
                        "help": m.help, "labels": list(m.labelnames),
                        "buckets": list(m.buckets),
                        "values": {k: {"counts": list(c["counts"]),
                                       "sum": c["sum"],
                                       "count": c["count"]}
                                   for k, c in m._values.items()}}
                else:
                    kind = "counters" if isinstance(m, Counter) else "gauges"
                    out[kind][name] = {
                        "help": m.help, "labels": list(m.labelnames),
                        "values": dict(m._values)}
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (one scrape). Histograms render
        the standard cumulative ``_bucket{le=...}`` / ``_sum`` /
        ``_count`` triple; events are not part of the format."""
        snap = self.snapshot()
        lines = []

        def fmt_labels(key, extra=None):
            labels = parse_label_key(key)
            if extra:
                labels = {**labels, **extra}
            if not labels:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
            return "{" + inner + "}"

        for kind, typ in (("counters", "counter"), ("gauges", "gauge")):
            for name, m in snap[kind].items():
                if m["help"]:
                    lines.append(f"# HELP {name} {m['help']}")
                lines.append(f"# TYPE {name} {typ}")
                for key, v in sorted(m["values"].items()):
                    lines.append(f"{name}{fmt_labels(key)} {v:g}")
        for name, m in snap["histograms"].items():
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} histogram")
            for key, cell in sorted(m["values"].items()):
                run = 0
                for bound, c in zip(m["buckets"] + [float("inf")],
                                    cell["counts"]):
                    run += c
                    le = "+Inf" if math.isinf(bound) else f"{bound:g}"
                    lines.append(f"{name}_bucket"
                                 f"{fmt_labels(key, {'le': le})} {run}")
                lines.append(f"{name}_sum{fmt_labels(key)} "
                             f"{cell['sum']:g}")
                lines.append(f"{name}_count{fmt_labels(key)} "
                             f"{cell['count']}")
        return "\n".join(lines) + "\n"

    def write_snapshot(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        return snap


class _BoundInstrument:
    """Instrument facade with some labels pre-bound (e.g. tenant=...).

    Forwards every read/write to the underlying registry instrument with
    the bound labels merged in, so a subsystem written against unlabeled
    instruments (the engine's ``engine_requests_total`` et al.) records
    per-scope series without knowing it is scoped. Explicit labels at the
    call site may not collide with bound ones — that would silently
    reattribute another scope's traffic."""

    __slots__ = ("_inst", "_bound")

    def __init__(self, inst, bound: dict):
        self._inst = inst
        self._bound = dict(bound)

    def _merge(self, labels: dict) -> dict:
        clash = set(labels) & set(self._bound)
        if clash:
            raise ValueError(f"labels {sorted(clash)} are bound by the "
                             f"scope and cannot be overridden")
        return {**self._bound, **labels}

    # Counter / Gauge surface
    def inc(self, by: float = 1.0, **labels):
        return self._inst.inc(by, **self._merge(labels))

    def set(self, value: float, **labels):
        return self._inst.set(value, **self._merge(labels))

    def value(self, **labels):
        return self._inst.value(**self._merge(labels))

    def total(self):
        return self._inst.total()

    # Histogram surface
    def observe(self, value: float, **labels):
        return self._inst.observe(value, **self._merge(labels))

    def counts(self, **labels):
        return self._inst.counts(**self._merge(labels))

    def count(self, **labels):
        return self._inst.count(**self._merge(labels))

    def sum(self, **labels):
        return self._inst.sum(**self._merge(labels))

    def percentile(self, q: float, **labels):
        return self._inst.percentile(q, **self._merge(labels))

    @property
    def name(self):
        return self._inst.name

    @property
    def labelnames(self):
        return self._inst.labelnames

    @property
    def buckets(self):
        return self._inst.buckets


class ScopedRegistry:
    """A MetricsRegistry view with label values bound up front.

    ``registry.scoped(tenant="a")`` returns a facade whose
    ``counter``/``gauge``/``histogram`` calls create the instrument on the
    *base* registry with the bound label names prepended to the declared
    ones, and hand back a ``_BoundInstrument`` that merges the bound
    values into every operation. Two scopes of the same base registry
    therefore share one instrument per name (identical labelnames — no
    get-or-create collision) while their series stay separated by label.
    This is how N per-tenant engines record ``engine_*`` metrics onto one
    router registry as ``engine_requests_total{tenant=...}``.

    Collectors and events forward to the base (events gain the bound
    attrs); ``snapshot``/``exposition``/``write_snapshot`` read the whole
    base registry — a scope is a *write* view, not a filtered read.
    """

    def __init__(self, base: "MetricsRegistry", **bound):
        if not bound:
            raise ValueError("a scope needs at least one bound label")
        while isinstance(base, ScopedRegistry):   # scopes of scopes flatten
            bound = {**base.bound, **bound}
            base = base.base
        for name in bound:
            if name in _RESERVED:
                raise ValueError(f"label name {name!r} is reserved")
        self.base = base
        self.bound = {k: str(v) for k, v in bound.items()}
        self.clock = base.clock

    def scoped(self, **bound) -> "ScopedRegistry":
        return ScopedRegistry(self, **bound)

    def _bound_names(self, labelnames) -> Tuple[str, ...]:
        extra = tuple(labelnames)
        clash = set(extra) & set(self.bound)
        if clash:
            raise ValueError(f"labelnames {sorted(clash)} are already "
                             f"bound by the scope")
        return tuple(self.bound) + extra

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _BoundInstrument:
        return _BoundInstrument(
            self.base.counter(name, help, self._bound_names(labelnames)),
            self.bound)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _BoundInstrument:
        return _BoundInstrument(
            self.base.gauge(name, help, self._bound_names(labelnames)),
            self.bound)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Optional[Sequence[float]] = None
                  ) -> _BoundInstrument:
        return _BoundInstrument(
            self.base.histogram(name, help, self._bound_names(labelnames),
                                buckets=buckets),
            self.bound)

    def register_collector(self, fn) -> None:
        self.base.register_collector(fn)

    def event(self, name: str, **attrs) -> None:
        self.base.event(name, **{**self.bound, **attrs})

    def events(self, name: Optional[str] = None) -> list:
        return self.base.events(name)

    def snapshot(self) -> dict:
        return self.base.snapshot()

    def exposition(self) -> str:
        return self.base.exposition()

    def write_snapshot(self, path: str) -> dict:
        return self.base.write_snapshot(path)


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two registry snapshots (e.g. per-worker registries into
    one fleet view): counters and histogram cells add, gauges take the
    later snapshot's value (b wins on conflict), events concatenate in
    time order. Histogram bucket layouts must match."""
    out = {"t": max(a.get("t", 0.0), b.get("t", 0.0)),
           "counters": {}, "gauges": {}, "histograms": {},
           "events": sorted([*a.get("events", []), *b.get("events", [])],
                            key=lambda e: e.get("t", 0.0))}
    for kind in ("counters", "gauges"):
        names = set(a.get(kind, {})) | set(b.get(kind, {}))
        for name in names:
            ma = a.get(kind, {}).get(name)
            mb = b.get(kind, {}).get(name)
            base = mb or ma
            merged = {"help": base["help"], "labels": base["labels"],
                      "values": dict((ma or base)["values"])}
            if ma and mb:
                for key, v in mb["values"].items():
                    if kind == "counters":
                        merged["values"][key] = (
                            merged["values"].get(key, 0.0) + v)
                    else:
                        merged["values"][key] = v      # later value wins
            elif mb:
                merged["values"] = dict(mb["values"])
            out[kind][name] = merged
    names = set(a.get("histograms", {})) | set(b.get("histograms", {}))
    for name in names:
        ma = a.get("histograms", {}).get(name)
        mb = b.get("histograms", {}).get(name)
        base = mb or ma
        merged = {"help": base["help"], "labels": base["labels"],
                  "buckets": list(base["buckets"]),
                  "values": {k: {"counts": list(c["counts"]),
                                 "sum": c["sum"], "count": c["count"]}
                             for k, c in (ma or base)["values"].items()}}
        if ma and mb:
            if list(ma["buckets"]) != list(mb["buckets"]):
                raise ValueError(f"histogram {name!r}: bucket layouts "
                                 f"differ, cannot merge")
            for key, c in mb["values"].items():
                cell = merged["values"].get(key)
                if cell is None:
                    merged["values"][key] = {"counts": list(c["counts"]),
                                             "sum": c["sum"],
                                             "count": c["count"]}
                else:
                    cell["counts"] = [x + y for x, y in
                                      zip(cell["counts"], c["counts"])]
                    cell["sum"] += c["sum"]
                    cell["count"] += c["count"]
        elif mb:
            merged["values"] = {k: {"counts": list(c["counts"]),
                                    "sum": c["sum"], "count": c["count"]}
                                for k, c in mb["values"].items()}
        out["histograms"][name] = merged
    return out


def index_memory(index) -> Dict[str, int]:
    """Resident bytes of a MetricIndex, by component — the ROADMAP's
    memory-budget accounting. Components (absent keys mean the backend
    has no such state):

      gallery     full-precision projected rows + norms on device
                  (ExactIndex gp/gn, IVF gp_pad/gn_pad segments, the
                  IVFPQ rerank rows with store="device");
      codes       PQ uint8 codes + per-row t term + codebooks;
      centroids   coarse-quantizer centers (IVF/IVFPQ);
      delta       MutableIndex delta buffer (host projected rows, ids,
                  tombstone masks);
      host_store  host-resident full-precision arrays: the IVFPQ rerank
                  store with store="host" (gp_full/gn_full) and
                  MutableIndex retained raw rows.

    Works on any backend, including a MutableIndex wrapper (wrapper
    components add to the base's).
    """
    out: Dict[str, int] = {}

    def add(key, *arrays):
        n = builtins_sum(a.nbytes for a in arrays if a is not None)
        if n:
            out[key] = out.get(key, 0) + int(n)

    base = getattr(index, "base", None)
    if base is not None and hasattr(index, "delta_gp"):   # MutableIndex
        add("delta", index.delta_gp, index.delta_gn, index.delta_ids,
            index.dead_delta, index.dead_base)
        add("host_store", index.raw_base, index.raw_delta)
        inner = index_memory(base)
        for k, v in inner.items():
            out[k] = out.get(k, 0) + v
        return out
    add("gallery", getattr(index, "gp", None), getattr(index, "gn", None),
        getattr(index, "gp_pad", None), getattr(index, "gn_pad", None))
    add("gallery", getattr(index, "ids_pad", None))
    add("centroids", getattr(index, "centroids", None))
    pq = getattr(index, "pq", None)
    if pq is not None:
        add("codes", getattr(index, "codes_pad", None),
            getattr(index, "t_pad", None),
            getattr(pq, "codebooks", None))
    full = (getattr(index, "gp_full", None), getattr(index, "gn_full", None))
    # the IVFPQ rerank rows: host memory, or the device with store="device"
    on_device = any(getattr(a, "is_cuda", False) for a in full)
    add("gallery" if on_device else "host_store", *full)
    return out
