"""Retrieval engine: bucketed, cached query execution over an index.

Counterpart of ``repro/serve/engine.py``. The engine owns the serving
concerns the index should not know about:

  * **batch bucketing** — incoming batches pad up to a small set of
    power-of-two bucket sizes (pad queries are sliced off the result),
    so the kernel sees a handful of shapes and its split plan and
    scratch sizes repeat;
  * **hot-query cache** — a bounded LRU keyed by (query bytes, k, knobs).
    A batch whose every row hits skips the device. ``index`` identity
    and ``index.version`` are the invalidation hooks;
  * **observability** — the engine owns the stack-wide
    ``MetricsRegistry`` and ``Tracer``: request/query/cache counters,
    the device-path latency histogram, per-index memory gauges, and the
    ``cache_lookup`` / ``pad`` / ``device_topk`` spans.

The device path ends in ``torch.cuda.synchronize()`` (the reference's
``block_until_ready``), so the latency histogram measures finished work.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry, Tracer, index_memory
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.index import MetricIndex

DEFAULT_BUCKETS = (8, 32, 128, 512)
DEFAULT_CACHE = 1024

# every component index_memory can report, so a collector can zero the
# ones the current index lacks (an index swap must not leave stale bytes)
_MEMORY_COMPONENTS = ("gallery", "codes", "centroids", "delta",
                      "host_store")


class RetrievalEngine:
    """Query executor over a MetricIndex: bucketing + caching + counters.

    One engine serves one index (swap ``engine.index`` to repoint it; the
    cache notices the identity change and flushes). Calls are expected
    from a single worker thread (the MicroBatcher provides exactly that);
    the registry-backed counters are safe under concurrent callers too.
    """

    def __init__(self, index: MetricIndex, k_top: int = 10,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 cache_size: int = DEFAULT_CACHE,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Clock] = None):
        if k_top < 1:
            raise ValueError(f"k_top must be >= 1, got {k_top}")
        self.index = index
        self.k_top = k_top
        self.buckets = tuple(sorted(buckets))
        self.cache_size = cache_size
        self.clock = clock if clock is not None else SystemClock()
        self.registry = (registry if registry is not None
                         else MetricsRegistry(clock=self.clock))
        self.tracer = (tracer if tracer is not None
                       else Tracer(clock=self.clock, sample_rate=0.0))
        r = self.registry
        self._c_requests = r.counter(
            "engine_requests_total", "search() calls")
        self._c_queries = r.counter(
            "engine_queries_total", "query rows received")
        self._c_device_queries = r.counter(
            "engine_device_queries_total",
            "query rows that reached the device (cache misses, incl. "
            "bucket pad overhead excluded)")
        self._c_busy = r.counter(
            "engine_busy_seconds_total", "device-path wall time")
        self._c_cache_hits = r.counter(
            "engine_cache_hits_total",
            "query rows served from the hot-query LRU")
        self._c_cache_misses = r.counter(
            "engine_cache_misses_total",
            "query rows that missed the LRU")
        self._h_search = r.histogram(
            "engine_search_seconds",
            "device-path latency per searched batch")
        self._g_cache_entries = r.gauge(
            "engine_cache_entries", "hot-query LRU entries resident")
        self._g_gallery_rows = r.gauge(
            "index_gallery_rows", "rows the served index holds")
        self._g_memory = r.gauge(
            "index_memory_bytes",
            "resident bytes of the served index, by component",
            labelnames=("component",))
        r.register_collector(self._collect_gauges)
        # (query f32 bytes, k, knobs) -> (dists (k,), idxs (k,)) numpy rows
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_index = index
        self._cache_version = index.version

    def _collect_gauges(self):
        self._g_cache_entries.set(len(self._cache))
        self._g_gallery_rows.set(self.index.size)
        mem = index_memory(self.index)
        for comp in _MEMORY_COMPONENTS:
            self._g_memory.set(mem.get(comp, 0), component=comp)

    @property
    def device(self) -> torch.device:
        return self.index.L.device

    @property
    def backend(self) -> str:
        """"cuda" when the index lives on the card (kernel path), else
        "cpu" (plain path)."""
        return "cuda" if self.device.type == "cuda" else "cpu"

    @property
    def n_requests(self) -> int:
        return int(self._c_requests.value())

    @property
    def n_queries(self) -> int:
        return int(self._c_queries.value())

    @property
    def n_device_queries(self) -> int:
        return int(self._c_device_queries.value())

    @property
    def busy_s(self) -> float:
        return self._c_busy.value()

    @property
    def cache_hits(self) -> int:
        return int(self._c_cache_hits.value())

    @property
    def cache_misses(self) -> int:
        return int(self._c_cache_misses.value())

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return n    # oversized batch: served as-is

    # -- hot-query LRU -------------------------------------------------------

    def _cache_lookup(self, keys):
        """Per-row lookup, refreshing LRU recency; hits count only when
        the whole batch hit (the caller settles the counters)."""
        if (self.index is not self._cache_index
                or self.index.version != self._cache_version):
            self.invalidate_cache()                      # invalidation hook
        rows = []
        for key in keys:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
            rows.append(hit)
        return rows

    def _cache_store(self, keys, dists, idxs):
        if self.cache_size <= 0:
            return
        for row, key in enumerate(keys):
            self._cache[key] = (dists[row].copy(), idxs[row].copy())
            self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def invalidate_cache(self):
        """Manual flush (version bumps and index swaps do this lazily on
        the next search)."""
        self._cache.clear()
        self._cache_index = self.index
        self._cache_version = self.index.version

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- search --------------------------------------------------------------

    def search(self, queries, k_top: Optional[int] = None, *,
               span=None, **topk_kw):
        """queries (Nq, d) or a single (d,) vector. Returns
        (dists (Nq, k_top), indices (Nq, k_top)) as numpy arrays.

        Extra keyword args forward to ``index.topk`` and join the cache
        key. ``span`` (never forwarded) is an obs.Span under which the
        engine records cache_lookup / pad / device_topk."""
        sp = span if span is not None else NULL_SPAN
        k = self.k_top if k_top is None else k_top
        if k < 1:
            raise ValueError(f"k_top must be >= 1, got {k}")
        knobs = tuple(sorted(topk_kw.items()))
        caching = self.cache_size > 0
        if torch.is_tensor(queries):
            q = queries.detach().to(torch.float32)
            q = q.cpu().numpy() if caching else q
        else:
            q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        n = q.shape[0]
        self._c_requests.inc()
        self._c_queries.inc(n)
        if n == 0:
            return (np.zeros((0, k), np.float32),
                    np.zeros((0, k), np.int32))

        keys = None
        if caching:                 # disabled cache pays no hashing
            c_sp = sp.child("cache_lookup")
            keys = [(row.tobytes(), k, knobs) for row in q]
            cached = self._cache_lookup(keys)
            if all(c is not None for c in cached):  # full hit: skip device
                self._c_cache_hits.inc(n)
                c_sp.set_attrs(hit=True, rows=n).end()
                dists = np.stack([c[0] for c in cached])
                idxs = np.stack([c[1] for c in cached])
                return (dists[0], idxs[0]) if single else (dists, idxs)
            self._c_cache_misses.inc(n)
            c_sp.set_attrs(hit=False, rows=n).end()

        q = torch.as_tensor(q, dtype=torch.float32).to(self.device)
        self._c_device_queries.inc(n)
        b = self._bucket(n)
        if b != n:      # pad rows are real compute but sliced from results
            with sp.child("pad").set_attrs(rows=n, bucket=b):
                q = torch.cat([q, q.new_zeros((b - n, q.shape[1]))])

        d_sp = sp.child("device_topk").set_attrs(
            batch=b, k=k, scan_impl=getattr(self.index, "scan_impl", None),
            nprobe=topk_kw.get("nprobe", getattr(self.index, "nprobe", None)),
            rerank_depth=topk_kw.get("rerank",
                                     getattr(self.index, "rerank_depth",
                                             None)))
        t0 = self.clock.now()
        dists, idxs = self.index.topk(q, k, **topk_kw)
        self._sync()
        dt = self.clock.now() - t0
        d_sp.end()
        self._c_busy.inc(dt)
        self._h_search.observe(dt)

        dists = dists[:n].cpu().numpy()
        idxs = idxs[:n].cpu().numpy()
        if keys is not None:
            self._cache_store(keys, dists, idxs)
        if single:
            return dists[0], idxs[0]
        return dists, idxs

    def warmup(self, ks: Optional[Sequence[int]] = None):
        """Run one search per (bucket, k) up front, so first requests pay
        neither the kernel's build nor first-launch costs. ``ks`` defaults
        to the engine's ``k_top``."""
        ks = (self.k_top,) if ks is None else tuple(ks)
        for k in ks:
            if k < 1:
                raise ValueError(f"k_top must be >= 1, got {k}")
        d = self.index.L.shape[1]
        for k in ks:
            for b in self.buckets:
                self.index.topk(torch.zeros((b, d), dtype=torch.float32,
                                            device=self.device), k)
        self._sync()

    def stats(self) -> dict:
        """Serving counters as a plain dict — the same keys as the
        reference's ``stats()``; ``backend`` is "cuda" or "cpu"."""
        busy = self.busy_s
        qps = self.n_device_queries / busy if busy > 0 else 0.0
        return {
            "n_requests": self.n_requests,
            "n_queries": self.n_queries,
            "n_device_queries": self.n_device_queries,
            "busy_s": busy,
            "qps": qps,
            "gallery_size": self.index.size,
            "n_shards": self.index.n_shards,
            "backend": self.backend,
            "index": type(self.index).__name__,
            "l_shape": list(self.index.L.shape),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_entries": len(self._cache),
        }
