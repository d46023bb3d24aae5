"""Unified observability: one metrics registry + request tracing layer.

The port keeps its own copy of ``repro/obs`` (which never imported jax)
so that ``repro_torch`` imports nothing of ``repro``. ``index_memory``
reads ``.nbytes``, which torch tensors have as numpy arrays do.

The measurement subsystem every other layer records into:

  metrics.py  ``MetricsRegistry`` with thread-safe labeled ``Counter`` /
              ``Gauge`` / ``Histogram`` (log-spaced latency buckets),
              mergeable snapshots, Prometheus text exposition, a bounded
              structured-event log, the single ``percentile``
              implementation, and ``index_memory`` byte accounting;
  trace.py    ``Tracer`` / ``Trace`` / ``Span`` — request-scoped span
              trees on an injectable clock, deterministic sampling,
              JSONL export.

Neither module imports jax or the serving stack (clocks are duck-typed),
so obs sits below everything: engine, scheduler, batcher, mutable index,
snapshots, miner, and the closed loop all share one registry/tracer pair
(see docs/observability.md for the metric catalog and span taxonomy).
"""

from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS,  # noqa: F401
                               Counter, Gauge, Histogram, MetricsRegistry,
                               ScopedRegistry, index_memory, log_buckets,
                               merge_snapshots, parse_label_key, percentile)
from repro_torch.obs.trace import (NULL_SPAN, NullSpan, Span,  # noqa: F401
                             Trace, Tracer, span_names)
