"""The port's serving stack held against the JAX reference's, on the CPU.

ExactIndex + RetrievalEngine + MicroBatcher of both packages get the same
numpy index arrays (carried over with repro_torch.convert) and the same
queries; both front doors run on a FakeClock so coalescing is exact.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import FakeClock as JaxFakeClock
from repro.serve import MicroBatcher as JaxMicroBatcher
from repro.serve import RetrievalEngine as JaxRetrievalEngine

from repro_torch.convert import exact_index_from_jax
from repro_torch.obs import index_memory, span_names
from repro_torch.serve import (ExactIndex, FakeClock, MetricIndex,
                               MicroBatcher, RetrievalEngine)
from repro_torch.serve.engine import DEFAULT_BUCKETS


def _data(Nq, M, d, k, seed=0):
    rng = np.random.RandomState(seed)
    L = (0.3 * rng.randn(k, d)).astype(np.float32)
    q = rng.randn(Nq, d).astype(np.float32)
    G = rng.randn(M, d).astype(np.float32)
    return L, q, G


def _pair(Nq=20, M=500, d=48, k=16, seed=0):
    """(JAX index, port index over the same arrays, queries)."""
    L, q, G = _data(Nq, M, d, k, seed)
    jidx = JaxExactIndex.build(jnp.asarray(L), jnp.asarray(G))
    pidx = exact_index_from_jax(np.asarray(jidx.L), np.asarray(jidx.gp),
                                np.asarray(jidx.gn), device="cpu")
    return jidx, pidx, q


def _drain(clock, futs, max_wait_s, guard_s=60.0):
    """Advance the fake clock until every future resolves (condition
    driven, as the reference's tests do)."""
    guard = time.monotonic() + guard_s
    while not all(f.done() for f in futs):
        assert time.monotonic() < guard, "futures never resolved"
        try:
            clock.wait_for_waiters(1, timeout=0.2)
        except TimeoutError:
            continue
        clock.advance(max_wait_s * 2)


def test_buckets_match_reference():
    from repro.serve.engine import DEFAULT_BUCKETS as JAX_BUCKETS
    assert DEFAULT_BUCKETS == JAX_BUCKETS
    _, pidx, _ = _pair()
    eng = RetrievalEngine(pidx, buckets=(32, 8))
    assert eng.buckets == (8, 32)
    assert [eng._bucket(n) for n in (1, 8, 9, 32, 33)] == [8, 8, 32, 32, 33]


def test_engine_matches_reference_engine():
    jidx, pidx, q = _pair()
    ref = JaxRetrievalEngine(jidx, k_top=7, buckets=(8, 32))
    eng = RetrievalEngine(pidx, k_top=7, buckets=(8, 32))
    d_ref, i_ref = ref.search(q)                # 20 pads to bucket 32
    dists, idxs = eng.search(q)
    assert isinstance(dists, np.ndarray) and idxs.dtype == np.int32
    np.testing.assert_array_equal(idxs, i_ref)
    np.testing.assert_allclose(dists, d_ref, rtol=1e-5, atol=1e-5)


def test_single_vector_request():
    jidx, pidx, q = _pair()
    eng = RetrievalEngine(pidx, k_top=7, buckets=(8, 32))
    _, i_all = eng.search(q)
    d1, i1 = eng.search(q[3])
    assert i1.shape == (7,) and d1.shape == (7,)
    np.testing.assert_array_equal(i1, i_all[3])
    _, i_ref = JaxRetrievalEngine(jidx, k_top=7).search(q[3])
    np.testing.assert_array_equal(i1, i_ref)
    assert eng.stats()["n_queries"] == 21


def test_stats_keys_match_reference():
    jidx, pidx, q = _pair()
    ref = JaxRetrievalEngine(jidx, k_top=5)
    eng = RetrievalEngine(pidx, k_top=5)
    ref.search(q)
    eng.search(q)
    st, st_ref = eng.stats(), ref.stats()
    assert set(st) == set(st_ref)
    for key in ("n_requests", "n_queries", "n_device_queries",
                "gallery_size", "n_shards", "index", "l_shape",
                "cache_hits", "cache_misses", "cache_entries"):
        assert st[key] == st_ref[key], key
    assert st["backend"] == "cpu"


def test_lru_hits_skip_the_device():
    _, pidx, q = _pair()
    eng = RetrievalEngine(pidx, k_top=5)
    first = eng.search(q)
    again = eng.search(q)
    np.testing.assert_array_equal(first[1], again[1])
    assert eng.cache_hits == 20 and eng.cache_misses == 20
    assert eng.n_device_queries == 20
    eng.search(q, k_top=4)                          # k joins the key
    assert eng.cache_misses == 40


def test_lru_invalidated_by_version_and_index_swap():
    _, pidx, q = _pair()
    eng = RetrievalEngine(pidx, k_top=5)
    eng.search(q)
    pidx.version += 1                               # mutation hook
    eng.search(q)
    assert eng.cache_hits == 0 and eng.cache_misses == 40
    _, other, _ = _pair(seed=1)
    eng.index = other                               # swap-in, version 0
    _, idx = eng.search(q)
    assert eng.cache_hits == 0
    np.testing.assert_array_equal(idx, RetrievalEngine(other, k_top=5)
                                  .search(q)[1])


def test_lru_eviction_is_bounded():
    _, pidx, q = _pair()
    eng = RetrievalEngine(pidx, k_top=3, cache_size=8)
    eng.search(q)
    assert eng.stats()["cache_entries"] == 8


def test_registry_and_spans_on_fake_clock():
    _, pidx, q = _pair()
    clock = FakeClock()
    eng = RetrievalEngine(pidx, k_top=3, clock=clock)
    eng.tracer.sample_rate = 1.0
    trace = eng.tracer.start_trace("request")
    eng.search(q, span=trace.root)
    eng.tracer.finish(trace)
    names = set(span_names(eng.tracer.drain()[0]))
    assert {"cache_lookup", "pad", "device_topk"} <= names
    snap = eng.registry.snapshot()
    hist = snap["histograms"]["engine_search_seconds"]["values"]
    assert sum(c["count"] for c in hist.values()) == 1
    mem = index_memory(pidx)
    assert mem["gallery"] == pidx.gp.numel() * 4 + pidx.gn.numel() * 4


def test_warmup_and_protocol():
    _, pidx, q = _pair()
    assert isinstance(pidx, MetricIndex) and pidx.n_shards == 1
    eng = RetrievalEngine(pidx, k_top=3, buckets=(8, 32))
    eng.warmup(ks=[3, 5])
    with pytest.raises(ValueError):
        eng.warmup(ks=[0])
    with pytest.raises(ValueError):
        eng.search(q, k_top=0)


def test_index_build_matches_reference_arrays():
    L, q, G = _data(8, 300, 32, 12, seed=4)
    jidx = JaxExactIndex.build(jnp.asarray(L), jnp.asarray(G))
    pidx = ExactIndex.build(torch.from_numpy(L), torch.from_numpy(G),
                            device="cpu")
    np.testing.assert_allclose(pidx.gp.numpy(), np.asarray(jidx.gp),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="sized d_out"):
        ExactIndex.from_projected(pidx.L, pidx.gp[:, :5], pidx.gn,
                                  device="cpu")
    with pytest.raises(ValueError):
        pidx.topk(torch.from_numpy(q), 301)


def test_microbatcher_matches_reference_batcher():
    jidx, pidx, q = _pair(Nq=30, M=300, d=32, k=16)
    results = {}
    for name, eng, clock in (
            ("port", RetrievalEngine(pidx, k_top=5), FakeClock()),
            ("ref", JaxRetrievalEngine(jidx, k_top=5), JaxFakeClock())):
        cls = MicroBatcher if name == "port" else JaxMicroBatcher
        mb = cls(eng, max_batch=16, max_wait_ms=20.0, clock=clock)
        futs = [mb.submit(q[i], k_top=3) for i in range(30)]
        _drain(clock, futs, mb.max_wait_s)
        results[name] = np.stack([f.result(timeout=60)[1] for f in futs])
        assert mb.close()
        assert list(mb.batch_sizes) == [16, 14]
    np.testing.assert_array_equal(results["port"], results["ref"])


def test_batcher_survives_cancelled_future_and_rejects_big_k():
    _, pidx, q = _pair(Nq=8, M=100, d=16, k=8)
    eng = RetrievalEngine(pidx, k_top=3)
    clock = FakeClock()
    mb = MicroBatcher(eng, max_batch=4, max_wait_ms=200.0, clock=clock)
    try:
        with pytest.raises(ValueError):
            mb.submit(q[0], k_top=9)
        doomed = mb.submit(q[0])
        assert doomed.cancel()
        alive = [mb.submit(q[i]) for i in range(1, 8)]
        _drain(clock, alive, mb.max_wait_s)
        for f in alive:
            assert f.result(timeout=30)[1].shape == (3,)
        assert doomed.cancelled()
    finally:
        assert mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(q[0])
