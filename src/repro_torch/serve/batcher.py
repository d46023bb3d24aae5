"""Request micro-batcher: coalesce single-query requests into engine batches.

Counterpart of ``repro/serve/batcher.py`` on the port's own clock,
registry and engine; the worker logic is the reference's, unchanged.

The serving front door. Callers submit one query vector at a time and get a
``concurrent.futures.Future`` back; a background thread drains the queue,
stacks up to ``max_batch`` queries (waiting at most ``max_wait_ms`` past
the first request so a lone query is never stranded), runs one engine
search, and distributes per-row results to the waiting futures.

Batching here is what turns the engine's bucketed batches into high
device utilization under many concurrent low-latency clients — the same
shape as the async parameter-server's request queue on the training side.

All timing (the coalescing wait) goes through an injectable ``Clock``
(serve/clock.py): production uses ``SystemClock``; tests drive the wait
deterministically with ``FakeClock.advance`` instead of sleeping. For
traffic shaping *above* this layer — admission control, priorities,
deadlines, adaptive degradation — see serve/scheduler.py, which forms its
own deadline-aware batches on the same clock contract.

Observability: batch counters live on the engine's ``MetricsRegistry``
(``batcher_batches_total`` / ``batcher_batch_size``), and when the
engine's ``Tracer`` is sampling, a trace minted at ``submit`` carries
queue-wait and coalesce spans into ``engine.search``.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.obs import MetricsRegistry
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.engine import RetrievalEngine


class MicroBatcher:
    def __init__(self, engine: RetrievalEngine, max_batch: int = 64,
                 max_wait_ms: float = 2.0, clock: Optional[Clock] = None):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.clock = clock if clock is not None else SystemClock()
        # record into the engine's registry/tracer so the whole stack
        # shares one; a bare test double gets a private registry
        reg = getattr(engine, "registry", None)
        self.registry = (reg if reg is not None
                         else MetricsRegistry(clock=self.clock))
        self.tracer = getattr(engine, "tracer", None)
        self._c_batches = self.registry.counter(
            "batcher_batches_total", "micro-batches sent to the engine")
        self._h_batch = self.registry.histogram(
            "batcher_batch_size", "coalesced requests per micro-batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._pending: collections.deque = collections.deque()
        self._closed = False
        # one condition guards the deque and the closed flag: every submit
        # lands before close() flips the flag, so no request can arrive
        # after the worker's exit signal
        self._cond = threading.Condition()
        # bounded: a long-lived server would otherwise grow this forever
        self.batch_sizes: collections.deque = collections.deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def n_batches(self) -> int:
        return int(self._c_batches.value())

    def submit(self, query, k_top: Optional[int] = None) -> Future:
        """Enqueue one (d,) query. Future resolves to (dists, indices),
        each (k_top,). k_top defaults to the engine's and must not exceed
        it (results are sliced from one shared engine batch)."""
        # `is None`, not truthiness: `k_top or default` silently mapped an
        # explicit k_top=0 to the default instead of rejecting it
        k = self.engine.k_top if k_top is None else k_top
        if k < 1:
            raise ValueError(f"k_top must be >= 1, got {k}")
        if k > self.engine.k_top:
            raise ValueError(f"k_top={k} > engine k_top={self.engine.k_top}")
        q = np.asarray(query, np.float32)
        d = self.engine.index.L.shape[1]
        if q.shape != (d,):     # reject here, not in the shared worker
            raise ValueError(f"query shape {q.shape} != ({d},)")
        fut: Future = Future()
        trace = q_span = None
        if self.tracer is not None and self.tracer.sample_rate > 0:
            trace = self.tracer.start_trace("request")
            trace.root.set_attrs(k=k)
            q_span = trace.span("queue")
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._pending.append((q, k, fut, trace, q_span))
            self._cond.notify_all()
        return fut

    def close(self, timeout: float = 10.0) -> bool:
        """Drain outstanding requests and stop the worker thread.

        Returns True when the worker exited within ``timeout`` (real)
        seconds, False when it is still alive — the join timing out used
        to pass silently, leaving a live thread with no signal to the
        caller. Idempotent; a False return may be retried.
        """
        with self._cond:
            self._closed = True
            self._cond.notify_all()         # wake the worker
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    # -- worker ------------------------------------------------------------

    def _collect(self):
        """Block for the first request, then gather more until the batch is
        full or the first request has waited max_wait_s (clock time)."""
        with self._cond:
            while not self._pending:
                if self._closed:
                    return None
                self.clock.wait_on(self._cond, None)
            batch = [self._pending.popleft()]
            deadline = self.clock.now() + self.max_wait_s
            while len(batch) < self.max_batch:
                if self._pending:
                    batch.append(self._pending.popleft())
                    continue
                if self._closed:            # nothing more is coming
                    break
                remaining = deadline - self.clock.now()
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
                if self._closed and not self._pending:
                    return

    def _finish_traces(self, batch, outcome: str) -> None:
        for _, _, _, trace, q_span in batch:
            if trace is None:
                continue
            trace.root.set_attrs(outcome=outcome)
            self.tracer.finish(trace)

    def _run_batch(self, batch):
        # dequeued: queue wait is over for every rider (end is idempotent)
        for _, _, _, _, q_span in batch:
            if q_span is not None:
                q_span.end()
        # one batch serves many requests but the engine takes one span:
        # the first *sampled* rider carries the coalesce + engine detail
        carrier = next((tr for _, _, _, tr, _ in batch
                        if tr is not None and tr.sampled), None)
        c_span = e_span = None
        if carrier is not None:
            c_span = carrier.span("coalesce").set_attrs(size=len(batch))
            e_span = carrier.span("engine", parent=c_span)
        # set_running_or_notify_cancel guards every resolution: a rider the
        # client cancelled while pending is skipped (resolving it would
        # raise InvalidStateError and kill the worker thread)
        try:
            qs = np.stack([q for q, _, _, _, _ in batch])
            if e_span is not None:
                dists, idxs = self.engine.search(qs, span=e_span)
            else:
                dists, idxs = self.engine.search(qs)
        except Exception as e:          # fail every rider, keep serving
            if c_span is not None:
                e_span.set_attrs(error=repr(e)).end()
                c_span.end()
            for _, _, fut, _, _ in batch:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
            self._finish_traces(batch, "failed")
            return
        if c_span is not None:
            e_span.end()
            c_span.end()
        self._c_batches.inc()
        self._h_batch.observe(len(batch))
        self.batch_sizes.append(len(batch))
        for row, (_, k, fut, _, _) in enumerate(batch):
            if fut.set_running_or_notify_cancel():
                fut.set_result((dists[row, :k], idxs[row, :k]))
        self._finish_traces(batch, "completed")
