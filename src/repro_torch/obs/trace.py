"""Request-scoped tracing: one trace id from submit to device top-k.

A trace is minted when a request enters the system
(``RequestScheduler.submit`` / ``MicroBatcher.submit``) and its id flows
with the request through every stage — queue wait, batch formation,
micro-batch coalesce, ``engine.search`` (cache lookup / pad / device
top-k, with ``scan_impl`` / ``nprobe`` / ``rerank_depth`` / batch size
as span attributes) — so one sampled trace answers "where did this
request's latency go" without correlating seven subsystems' logs.

Design points:

  clock-driven     every timestamp reads the injected ``clock.now()``
                   (duck-typed; serve/clock.py's ``Clock`` fits), so
                   span durations are asserted *exactly* under
                   ``FakeClock`` — no sleep-based tests;
  sampled          the ``sample_rate`` knob decides at mint time with a
                   deterministic accumulator (rate 0.25 samples exactly
                   every 4th trace — reproducible, not a coin flip). An
                   unsampled trace costs two attribute reads: its spans
                   are a shared no-op ``NullSpan``;
  cross-thread     spans are explicit objects handed across threads
                   (submit thread -> worker -> engine), not
                   thread-locals — the serving stack moves requests
                   between threads as a matter of course;
  bounded + JSONL  finished traces land in a bounded ring; ``drain()``
                   hands them out as plain dicts and ``write_jsonl``
                   appends one JSON object per line (the
                   ``--trace-out`` format benchmarks/check_obs.py
                   validates).

Like obs/metrics.py, this module imports nothing from the serving
stack, so it sits below every subsystem without cycles.
"""

from __future__ import annotations

import json
import threading
from typing import Optional


class NullSpan:
    """No-op span: the unsampled path. All methods return self so call
    sites never branch on sampling."""

    __slots__ = ()
    sampled = False

    def set_attrs(self, **attrs):
        return self

    def child(self, name):
        return self

    def end(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = NullSpan()


class Span:
    """One timed stage of a trace. ``end()`` stamps the close time (it
    is idempotent; re-ending keeps the first close). ``child`` opens a
    nested span at the current clock time."""

    __slots__ = ("name", "t_start", "t_end", "attrs", "children", "_clock")
    sampled = True

    def __init__(self, name: str, clock):
        self.name = name
        self._clock = clock
        self.t_start = clock.now()
        self.t_end: Optional[float] = None
        self.attrs: dict = {}
        self.children: list = []

    def set_attrs(self, **attrs):
        self.attrs.update(attrs)
        return self

    def child(self, name: str) -> "Span":
        sp = Span(name, self._clock)
        self.children.append(sp)
        return sp

    def end(self):
        if self.t_end is None:
            self.t_end = self._clock.now()
        return self

    @property
    def duration(self) -> float:
        return (self.t_end if self.t_end is not None
                else self._clock.now()) - self.t_start

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def to_dict(self) -> dict:
        return {"name": self.name, "t_start": self.t_start,
                "t_end": self.t_end, "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}


class Trace:
    """One request's span tree. ``sampled=False`` traces carry only the
    id; every span they hand out is the shared NullSpan."""

    __slots__ = ("trace_id", "sampled", "root", "_clock")

    def __init__(self, trace_id: str, sampled: bool, clock,
                 root_name: str = "request"):
        self.trace_id = trace_id
        self.sampled = sampled
        self._clock = clock
        self.root = Span(root_name, clock) if sampled else NULL_SPAN

    def span(self, name: str, parent=None):
        """Open a span under ``parent`` (default: the root)."""
        if not self.sampled:
            return NULL_SPAN
        return (parent if parent is not None else self.root).child(name)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "root": self.root.to_dict()}


class Tracer:
    """Mints traces, applies sampling, and buffers finished ones.

    ``sample_rate`` in [0, 1]: 0 disables tracing entirely (the default
    for a bare engine — zero overhead on the hot path), 1 records every
    request. Rates in between sample deterministically: an accumulator
    adds ``rate`` per mint and fires each time it crosses 1, so n mints
    yield exactly ``floor(n * rate)`` (±0 — reproducible) samples.
    """

    def __init__(self, clock=None, sample_rate: float = 0.0,
                 max_traces: int = 1024):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got "
                             f"{sample_rate}")
        if clock is None:
            from repro_torch.obs.metrics import _MonotonicClock
            clock = _MonotonicClock()
        self.clock = clock
        self.sample_rate = sample_rate
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self._acc = 0.0
        self._n_minted = 0
        self._n_sampled = 0
        self._finished: list = []

    def start_trace(self, root_name: str = "request",
                    force: bool = False) -> Trace:
        """Mint a trace (always returns one; sampling decides whether
        it records). ``force=True`` bypasses sampling — control-plane
        traces (closed-loop refreshes) are rare and always wanted."""
        with self._lock:
            self._n_minted += 1
            tid = f"t{self._n_minted:08x}"
            if force:
                sampled = True
            else:
                self._acc += self.sample_rate
                sampled = self._acc >= 1.0 - 1e-12
                if sampled:
                    self._acc -= 1.0
            if sampled:
                self._n_sampled += 1
        return Trace(tid, sampled, self.clock, root_name)

    def finish(self, trace: Trace) -> None:
        """Close the root span and (for sampled traces) buffer the
        finished tree for export. Unsampled traces are dropped here."""
        if not trace.sampled:
            return
        trace.root.end()
        with self._lock:
            self._finished.append(trace.to_dict())
            if len(self._finished) > self.max_traces:
                del self._finished[:len(self._finished) - self.max_traces]

    @property
    def n_minted(self) -> int:
        with self._lock:
            return self._n_minted

    @property
    def n_sampled(self) -> int:
        with self._lock:
            return self._n_sampled

    def drain(self) -> list:
        """Hand out (and clear) the finished-trace buffer."""
        with self._lock:
            out = self._finished
            self._finished = []
        return out

    def write_jsonl(self, path: str, append: bool = True) -> int:
        """Drain finished traces to ``path`` as JSON-lines; returns how
        many were written."""
        traces = self.drain()
        if traces:
            with open(path, "a" if append else "w") as f:
                for tr in traces:
                    f.write(json.dumps(tr, sort_keys=True) + "\n")
        return len(traces)


def span_names(trace_dict: dict) -> list:
    """Flatten a finished trace dict into depth-first span names —
    the shape assertions in tests and check_obs read."""
    out = []

    def walk(span):
        out.append(span["name"])
        for c in span.get("children", ()):
            walk(c)

    walk(trace_dict["root"])
    return out
