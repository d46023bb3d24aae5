"""The port's traffic-shaped front end, on the CPU: admission,
priorities, deadlines, degradation, close semantics, stats, the storms
and tenant routes — the reference's cases (tests/test_serve_scheduler.py)
run on ``repro_torch.serve.RequestScheduler``, all deterministic on
FakeClock through the numpy-only ``FakeEngine`` — then one request
sequence through both packages' schedulers over engines carried across
with ``repro_torch.convert``: the same batches, knobs, transitions and
outcomes, answers with ids equal and distances within atol + rtol *
(||qp||² + ||gp||²), rtol = atol = 1e-5 (the repo's rule for the factored
distance, whose f32 rounding scales with the operands' norms).

Choreography: a cleared FakeEngine ``gate`` pins the worker inside the
engine (rendezvous via ``entered``), the test stuffs / advances /
inspects queues in a known state, then opens the gate. With virtual time
frozen, pop order, batch contents and controller decisions are exact.
"""

import threading
from concurrent.futures import CancelledError
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _traffic_utils import FakeEngine, make_query
from repro.serve import DeadlineExceededError as JaxDeadlineExceededError
from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import FakeClock as JaxFakeClock
from repro.serve import IVFIndex as JaxIVFIndex
from repro.serve import IVFPQIndex as JaxIVFPQIndex
from repro.serve import RequestScheduler as JaxRequestScheduler
from repro.serve import RetrievalEngine as JaxRetrievalEngine
from repro.serve import default_ladder as jax_default_ladder

from repro_torch.convert import (exact_index_from_jax, ivf_index_from_jax,
                                 ivfpq_index_from_jax)
from repro_torch.serve import (DEFAULT_CLASSES, DeadlineExceededError,
                               ExactIndex, FakeClock, IVFIndex,
                               LatencyWindow, LoadController, MicroBatcher,
                               PriorityClass, RejectedError,
                               RequestScheduler, RetrievalEngine,
                               default_ladder)

D = 4
CPU = "cpu"


def _scheduler(eng, clock, **kw):
    kw.setdefault("max_wait_ms", 0.0)
    return RequestScheduler(eng, clock=clock, **kw)


def _plug(eng, sched, rid=999):
    """Park the worker inside the engine: close the gate, submit a plug
    request, and wait until the engine reports the worker entered."""
    eng.gate.clear()
    eng.entered.clear()
    fut = sched.submit(make_query(D, rid), priority="mining")
    assert eng.entered.wait(timeout=30), "worker never reached the engine"
    return fut


def test_default_classes_match_reference():
    from repro.serve import DEFAULT_CLASSES as JAX_CLASSES
    assert [(c.name, c.priority, c.deadline_s, c.queue_cap)
            for c in DEFAULT_CLASSES] == \
        [(c.name, c.priority, c.deadline_s, c.queue_cap)
         for c in JAX_CLASSES] == \
        [("interactive", 0, 0.1, 256), ("batch", 1, 1.0, 1024),
         ("mining", 2, 10.0, 4096)]


class TestPriorityAndDeadlines:
    def test_batch_formed_priority_first_fifo_within_class(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), max_batch=16, degrade=False)
        try:
            plug = _plug(eng, sched)
            subs = [(100, "batch"), (101, "batch"), (200, "mining"),
                    (10, "interactive"), (11, "interactive")]
            futs = [sched.submit(make_query(D, r), priority=p)
                    for r, p in subs]
            eng.gate.set()
            plug.result(timeout=30)
            for f in futs:
                f.result(timeout=30)
            assert eng.calls[1][0] == [10, 11, 100, 101, 200]
        finally:
            assert sched.close()

    def test_expired_fail_fast_and_never_reach_engine(self):
        eng = FakeEngine(d=D)
        clock = FakeClock()
        sched = _scheduler(eng, clock, degrade=False)
        try:
            plug = _plug(eng, sched)
            doomed = [sched.submit(make_query(D, r), deadline_s=0.05)
                      for r in (1, 2, 3)]
            alive = sched.submit(make_query(D, 4), deadline_s=10.0)
            clock.advance(0.1)
            eng.gate.set()
            plug.result(timeout=30)
            assert alive.result(timeout=30)[1].shape == (eng.k_top,)
            for f in doomed:
                with pytest.raises(DeadlineExceededError):
                    f.result(timeout=30)
            assert eng.served_ids() == [999, 4]
            st = sched.stats()["classes"]["interactive"]
            assert st["expired"] == 3 and st["completed"] == 1
        finally:
            assert sched.close()

    def test_submit_validation(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), degrade=False)
        try:
            with pytest.raises(ValueError):
                sched.submit(make_query(D, 0), priority="vip")
            with pytest.raises(ValueError):
                sched.submit(make_query(D, 0), k_top=0)
            with pytest.raises(ValueError):
                sched.submit(make_query(D, 0), k_top=eng.k_top + 1)
            with pytest.raises(ValueError):
                sched.submit(make_query(D, 0), deadline_s=0.0)
            with pytest.raises(ValueError):
                sched.submit(np.zeros((D + 1,), np.float32))
            with pytest.raises(ValueError, match="n_workers"):
                RequestScheduler(eng, n_workers=0)
            dup = (PriorityClass("a", 0, 1.0, 4),
                   PriorityClass("a", 1, 1.0, 4))
            with pytest.raises(ValueError, match="duplicate"):
                RequestScheduler(eng, classes=dup)
        finally:
            assert sched.close()


class TestAdmissionControl:
    def test_bounded_queue_rejects_typed(self):
        eng = FakeEngine(d=D)
        classes = (PriorityClass("interactive", 0, 1.0, queue_cap=2),
                   PriorityClass("mining", 2, 10.0, queue_cap=8))
        sched = _scheduler(eng, FakeClock(), classes=classes,
                           degrade=False)
        try:
            plug = _plug(eng, sched)
            ok = [sched.submit(make_query(D, r)) for r in (1, 2)]
            with pytest.raises(RejectedError):
                sched.submit(make_query(D, 3))
            st = sched.stats()["classes"]["interactive"]
            assert st["rejected"] == 1 and st["queue_depth"] == 2
            eng.gate.set()
            for f in ok + [plug]:
                f.result(timeout=30)
            assert 3 not in eng.served_ids()
        finally:
            assert sched.close()

    def test_rejection_is_synchronous_no_future_leak(self):
        eng = FakeEngine(d=D)
        classes = (PriorityClass("interactive", 0, 1.0, queue_cap=1),)
        sched = _scheduler(eng, FakeClock(), classes=classes,
                           degrade=False)
        try:
            eng.gate.clear()
            eng.entered.clear()
            f1 = sched.submit(make_query(D, 1))
            assert eng.entered.wait(timeout=30)
            f2 = sched.submit(make_query(D, 2))
            with pytest.raises(RejectedError):
                sched.submit(make_query(D, 3))
            eng.gate.set()
            assert f1.result(timeout=30) and f2.result(timeout=30)
        finally:
            assert sched.close()


class TestCloseSemantics:
    def test_close_reports_failure_then_success(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), degrade=False)
        plug = _plug(eng, sched)
        assert sched.close(timeout=0.2) is False
        eng.gate.set()
        assert sched.close(timeout=30) is True
        assert plug.result(timeout=30)

    def test_close_drain_false_fails_pending_typed(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), degrade=False)
        plug = _plug(eng, sched)
        pending = [sched.submit(make_query(D, r)) for r in (1, 2, 3)]
        sched.close(timeout=0.0, drain=False)
        for f in pending:
            with pytest.raises(RejectedError):
                f.result(timeout=30)
        eng.gate.set()
        assert sched.close(timeout=30) is True
        assert plug.result(timeout=30)
        assert eng.served_ids() == [999]
        with pytest.raises(RejectedError):
            sched.submit(make_query(D, 4))

    def test_batcher_close_reports_failure_then_success(self):
        eng = FakeEngine(d=D)
        mb = MicroBatcher(eng, max_batch=4, max_wait_ms=0.0,
                          clock=FakeClock())
        eng.gate.clear()
        eng.entered.clear()
        fut = mb.submit(make_query(D, 1))
        assert eng.entered.wait(timeout=30)
        assert mb.close(timeout=0.2) is False
        eng.gate.set()
        assert mb.close(timeout=30) is True
        assert fut.result(timeout=30)


class TestDegradation:
    def test_controller_degrade_and_restore_windows(self):
        clock = FakeClock()
        ladder = ({}, {"nprobe": 4}, {"nprobe": 2})
        c = LoadController(ladder, clock, high_watermark=8,
                           low_watermark=2, degrade_window_s=0.05,
                           restore_window_s=0.5)
        assert c.observe(20) == {}
        clock.advance(0.04)
        assert c.observe(20) == {}
        clock.advance(0.02)
        assert c.observe(20) == {"nprobe": 4}
        assert c.observe(20) == {"nprobe": 4}
        clock.advance(0.06)
        assert c.observe(20) == {"nprobe": 2}
        clock.advance(1.0)
        assert c.observe(20) == {"nprobe": 2}
        assert c.observe(5) == {"nprobe": 2}
        assert c.observe(0) == {"nprobe": 2}
        clock.advance(0.6)
        assert c.observe(0) == {"nprobe": 4}
        assert c.observe(0) == {"nprobe": 4}
        clock.advance(0.6)
        assert c.observe(0) == {}
        levels = [(t.level_from, t.level_to) for t in c.transitions]
        assert levels == [(0, 1), (1, 2), (2, 1), (1, 0)]
        assert all(t.reason for t in c.transitions)
        ts = [t.t for t in c.transitions]
        assert ts == sorted(ts)

    def test_degrade_knobs_reach_engine(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(
            eng, FakeClock(), max_batch=2, degrade=True,
            ladder=({}, {"nprobe": 2}), high_watermark=2, low_watermark=1,
            degrade_window_s=0.0)
        try:
            plug = _plug(eng, sched)
            futs = [sched.submit(make_query(D, r)) for r in range(8)]
            eng.gate.set()
            plug.result(timeout=30)
            for f in futs:
                f.result(timeout=30)
            assert eng.call_kwargs() == [{}, {}, {"nprobe": 2},
                                         {"nprobe": 2}, {"nprobe": 2}]
            st = sched.stats()
            assert st["degradation_level"] == 1
            assert st["degradation_knobs"] == {"nprobe": 2}
            assert st["n_transitions"] == 1
            tr = sched.controller.transitions[0]
            assert (tr.level_from, tr.level_to) == (0, 1)
            assert tr.queue_depth == 4
        finally:
            assert sched.close()

    def test_default_ladder_from_index_knobs(self):
        ivf = SimpleNamespace(nprobe=8, cap=16)
        assert default_ladder(ivf, k_top=10) == (
            {}, {"nprobe": 4}, {"nprobe": 2})
        pq = SimpleNamespace(nprobe=8, cap=16, rerank_depth=64)
        assert default_ladder(pq, k_top=10) == (
            {}, {"rerank": 32},
            {"nprobe": 4, "rerank": 32}, {"nprobe": 2, "rerank": 16})
        assert default_ladder(pq, k_top=40, n_levels=4) == (
            {}, {"rerank": 40},
            {"nprobe": 4, "rerank": 40}, {"nprobe": 3, "rerank": 40})
        assert default_ladder(SimpleNamespace(nprobe=8, cap=16,
                                              rerank_depth=10),
                              k_top=10) == (
            {}, {"nprobe": 4, "rerank": 10}, {"nprobe": 2, "rerank": 10})
        wrapped = SimpleNamespace(base=ivf)
        assert default_ladder(wrapped, k_top=10) == (
            {}, {"nprobe": 4}, {"nprobe": 2})
        assert default_ladder(SimpleNamespace(), k_top=10) == ({},)
        assert default_ladder(SimpleNamespace(nprobe=2, cap=16),
                              k_top=10) == ({}, {"nprobe": 1})

    @pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq", "mutable"])
    def test_default_ladder_of_port_indexes_matches_reference(self, base):
        """The ladder the port derives from its own indexes equals the
        reference's from the reference's (the same knobs carried
        across): phase 8's widths scaled down, nprobe 16, rerank 50."""
        rng = np.random.RandomState(0)
        G = rng.randn(600, 16).astype(np.float32)
        L = (0.3 * rng.randn(8, 16)).astype(np.float32)
        jidx, pidx = _index_pair("ivfpq" if base == "mutable" else base,
                                 L, G, n_clusters=24, nprobe=16)
        if base == "mutable":
            from repro_torch.serve import MutableIndex
            pidx = MutableIndex(pidx, pidx.L)
            jidx = SimpleNamespace(base=jidx)
        for k in (1, 10, 40):
            assert default_ladder(pidx, k) == jax_default_ladder(jidx, k)
        expect = {"exact": ({},),
                  "ivf": ({}, {"nprobe": 8}, {"nprobe": 4}),
                  "ivfpq": ({}, {"rerank": 25}, {"nprobe": 8, "rerank": 25},
                            {"nprobe": 4, "rerank": 12})}
        assert default_ladder(pidx, 10) == expect[
            "ivfpq" if base == "mutable" else base]

    def test_ladder_validation(self):
        clock = FakeClock()
        with pytest.raises(ValueError):
            LoadController(({"nprobe": 2},), clock)
        with pytest.raises(ValueError):
            LoadController(({},), clock, high_watermark=4,
                           low_watermark=4)


class TestStatsObservability:
    def test_latency_window_percentiles_on_known_samples(self):
        w = LatencyWindow(maxlen=1024)
        samples = [0.010, 0.020, 0.030, 0.040, 0.100]
        for s in samples:
            w.record(s)
        assert w.percentile(50.0) == pytest.approx(
            np.percentile(samples, 50.0))
        p50, p99 = w.percentile((50.0, 99.0))
        assert p50 == pytest.approx(0.030)
        assert p99 == pytest.approx(np.percentile(samples, 99.0))
        assert len(w) == 5
        empty = LatencyWindow()
        assert np.isnan(empty.percentile(99.0))
        assert all(np.isnan(v) for v in empty.percentile((50.0, 99.0)))
        small = LatencyWindow(maxlen=3)
        for s in (1.0, 2.0, 3.0, 4.0):
            small.record(s)
        assert small.percentile(50.0) == pytest.approx(3.0)

    def test_scheduler_latency_percentiles_on_fake_clock(self):
        eng = FakeEngine(d=D)
        clock = FakeClock()
        sched = _scheduler(eng, clock, degrade=False)
        try:
            plug = _plug(eng, sched)
            fut = sched.submit(make_query(D, 1), deadline_s=10.0)
            clock.advance(0.25)
            eng.gate.set()
            plug.result(timeout=30)
            fut.result(timeout=30)
            st = sched.stats()["classes"]["interactive"]
            assert st["p50_ms"] == pytest.approx(250.0)
            assert st["p99_ms"] == pytest.approx(250.0)
        finally:
            assert sched.close()

    def test_counters_monotone_and_race_free_under_concurrent_submit(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), max_batch=8, degrade=False)
        errs: list = []

        def client(tid):
            try:
                for i in range(200):
                    try:
                        sched.submit(make_query(D, tid * 1000 + i))
                    except RejectedError:
                        pass
            except Exception as e:          # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        prev: dict = {}
        counter_keys = ("admitted", "rejected", "expired", "completed",
                        "failed", "cancelled")
        while any(t.is_alive() for t in threads):
            snap = sched.observability()
            for name, cls in snap["classes"].items():
                for key in counter_keys:
                    assert cls[key] >= prev.get((name, key), 0)
                    prev[(name, key)] = cls[key]
                assert cls["completed"] + cls["expired"] <= cls["admitted"]
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errs
        assert sched.close()
        snap = sched.observability()["classes"]["interactive"]
        assert snap["admitted"] == 800 - snap["rejected"]
        assert snap["admitted"] == (snap["completed"] + snap["expired"]
                                    + snap["cancelled"] + snap["failed"])

    def test_engine_stats_frontend_block_absent_then_present(self):
        """The engine repair: a port engine has ``frontend = None`` and no
        ``frontend`` block until a scheduler attaches; then ``stats()``
        carries the reference's block with its keys."""
        rng = np.random.RandomState(0)
        G = rng.randn(200, 8).astype(np.float32)
        L = 0.3 * rng.randn(4, 8).astype(np.float32)
        eng = RetrievalEngine(ExactIndex.build(L, G, device=CPU), k_top=3)
        assert eng.frontend is None and "frontend" not in eng.stats()
        jeng = JaxRetrievalEngine(JaxExactIndex.build(jnp.asarray(L),
                                                      jnp.asarray(G)),
                                  k_top=3)
        sched = RequestScheduler(eng, clock=FakeClock(), max_wait_ms=0.0)
        jsched = JaxRequestScheduler(jeng, clock=JaxFakeClock(),
                                     max_wait_ms=0.0)
        try:
            assert eng.frontend is sched
            d, i = sched.submit(G[0]).result(timeout=60)
            ref_d, ref_i = eng.search(G[0])
            np.testing.assert_array_equal(i, ref_i)
            jsched.submit(G[0]).result(timeout=60)
            fe, jfe = eng.stats()["frontend"], jeng.stats()["frontend"]
            assert set(fe) == set(jfe)
            assert set(fe["classes"]["interactive"]) == \
                set(jfe["classes"]["interactive"])
            assert fe["classes"]["interactive"]["completed"] == 1
            assert fe["degradation_level"] == 0
            assert fe["queue_depth"] == 0
        finally:
            assert sched.close() and jsched.close()

    def test_engine_cache_keys_include_degradation_knobs(self):
        rng = np.random.RandomState(0)
        G = rng.randn(512, 16).astype(np.float32)
        L = 0.3 * rng.randn(8, 16).astype(np.float32)
        eng = RetrievalEngine(
            IVFIndex.build(L, G, n_clusters=8, nprobe=8, device=CPU),
            k_top=5, cache_size=64)
        q = G[0]
        eng.search(q)
        eng.search(q)
        assert (eng.cache_hits, eng.cache_misses) == (1, 1)
        eng.search(q, nprobe=1)
        assert eng.cache_misses == 2
        eng.search(q, nprobe=1)
        assert eng.cache_hits == 2
        assert len(eng._cache) == 2
        d_full, i_full = eng.search(q)
        np.testing.assert_array_equal(
            i_full, eng.search(q, nprobe=8)[1])

    def test_warmup_runs_every_ladder_level(self):
        """``warmup`` reaches index.topk at every (level, k, bucket) with
        the level's knobs on the engine's device."""
        rng = np.random.RandomState(1)
        G = rng.randn(400, 16).astype(np.float32)
        L = 0.3 * rng.randn(8, 16).astype(np.float32)
        idx = IVFIndex.build(L, G, n_clusters=8, nprobe=8, device=CPU)
        eng = RetrievalEngine(idx, k_top=5, buckets=(2, 4))
        seen = []
        real = idx.topk

        def spy(q, k, **kw):
            seen.append((q.shape[0], k, q.device.type, kw))
            return real(q, k, **kw)

        idx.topk = spy
        sched = RequestScheduler(eng, clock=FakeClock())
        try:
            sched.warmup(ks=(3, 5))
        finally:
            assert sched.close()
        ladder = sched.controller.ladder
        assert ladder == ({}, {"nprobe": 4}, {"nprobe": 2})
        assert seen == [(b, k, "cpu", kw) for kw in ladder
                        for k in (3, 5) for b in (2, 4)]


class TestStressInterleavings:
    """N submitters racing close / cancel / engine-exception events. The
    invariants hold under every interleaving."""

    N_THREADS = 6
    N_PER = 40

    def _storm(self, submit_one):
        futs: list = []
        futs_lock = threading.Lock()
        rejected = [0]

        def client(tid):
            for i in range(self.N_PER):
                rid = tid * 1000 + i
                try:
                    f = submit_one(rid)
                except (RejectedError, RuntimeError):
                    with futs_lock:
                        rejected[0] += 1
                    continue
                with futs_lock:
                    futs.append(f)
                if i % 7 == 3:
                    f.cancel()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(self.N_THREADS)]
        for t in threads:
            t.start()
        return threads, futs, rejected

    def _assert_exactly_once(self, futs, allowed_errors):
        outcomes = {"result": 0, "error": 0, "cancelled": 0}
        for f in futs:
            assert f.done(), "an admitted future never resolved"
            if f.cancelled():
                outcomes["cancelled"] += 1
                continue
            err = f.exception(timeout=0)
            if err is None:
                assert f.result(timeout=0)[1].shape[0] > 0
                outcomes["result"] += 1
            else:
                assert isinstance(err, allowed_errors), repr(err)
                outcomes["error"] += 1
        assert sum(outcomes.values()) == len(futs)
        return outcomes

    def test_scheduler_storm_every_future_resolves_exactly_once(self):
        eng = FakeEngine(d=D)
        clock = FakeClock()
        classes = (PriorityClass("interactive", 0, 5.0, queue_cap=64),)
        sched = RequestScheduler(eng, classes=classes, max_batch=8,
                                 max_wait_ms=1.0, clock=clock,
                                 degrade=False)
        threads, futs, rejected = self._storm(
            lambda rid: sched.submit(make_query(D, rid)))
        for _ in range(10):
            eng.fail = not eng.fail
            clock.advance(0.8)
        eng.fail = False
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert sched.close(timeout=60) is True, "worker did not survive"
        outcomes = self._assert_exactly_once(
            futs, (RuntimeError, DeadlineExceededError))
        st = sched.observability()["classes"]["interactive"]
        assert st["admitted"] == len(futs)
        assert st["rejected"] == rejected[0]
        assert st["admitted"] == (st["completed"] + st["expired"]
                                  + st["failed"] + st["cancelled"])
        assert outcomes["result"] == st["completed"]
        assert eng.calls, "no batch ever reached the engine"

    def test_batcher_storm_every_future_resolves_exactly_once(self):
        eng = FakeEngine(d=D)
        clock = FakeClock()
        mb = MicroBatcher(eng, max_batch=8, max_wait_ms=1.0, clock=clock)
        threads, futs, _ = self._storm(
            lambda rid: mb.submit(make_query(D, rid)))
        for _ in range(10):
            eng.fail = not eng.fail
            clock.advance(0.01)
        eng.fail = False
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert mb.close(timeout=60) is True, "worker did not survive"
        self._assert_exactly_once(futs, (RuntimeError,))
        assert sum(mb.batch_sizes) <= len(futs)

    def test_cancelled_future_raises_cancelled_error_to_caller(self):
        eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), degrade=False)
        try:
            plug = _plug(eng, sched)
            doomed = sched.submit(make_query(D, 1))
            assert doomed.cancel()
            eng.gate.set()
            plug.result(timeout=30)
            with pytest.raises(CancelledError):
                doomed.result(timeout=30)
            assert 1 not in eng.served_ids()
        finally:
            assert sched.close()


class TestTenantRoutes:
    def test_routed_batches_never_mix_and_serve_route_engine(self):
        eng = FakeEngine(d=D)
        route_eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), max_batch=16, degrade=False)
        try:
            sched.add_route("a", route_eng)
            assert sched.routes() == ("a",)
            plug = _plug(eng, sched)
            futs = [sched.submit(make_query(D, rid),
                                 route=("a" if rid % 2 else None))
                    for rid in range(1, 7)]
            eng.gate.set()
            route_eng.gate.set()
            for f in futs:
                f.result(timeout=30)
            plug.result(timeout=30)
            assert set(eng.served_ids()) == {999, 2, 4, 6}
            assert set(route_eng.served_ids()) == {1, 3, 5}
            for ids, _ in route_eng.calls:
                assert all(i % 2 for i in ids)
        finally:
            assert sched.close()

    def test_route_validation_and_unknown_route(self):
        eng = FakeEngine(d=D)
        small = FakeEngine(d=D, k_top=2)
        sched = _scheduler(eng, FakeClock(), degrade=False)
        try:
            sched.add_route("small", small)
            with pytest.raises(ValueError, match="unknown route"):
                sched.submit(make_query(D, 1), route="nope")
            with pytest.raises(ValueError, match="k_top"):
                sched.submit(make_query(D, 1), k_top=5, route="small")
            sched.submit(make_query(D, 1), k_top=5)
        finally:
            assert sched.close()

    def test_tenant_outcomes_in_observability(self):
        eng = FakeEngine(d=D)
        route_eng = FakeEngine(d=D)
        sched = _scheduler(eng, FakeClock(), degrade=False)
        try:
            sched.add_route("a", route_eng)
            plug = _plug(eng, sched)
            futs = [sched.submit(make_query(D, rid), route="a")
                    for rid in (1, 2)]
            eng.gate.set()
            route_eng.gate.set()
            for f in futs:
                f.result(timeout=30)
            plug.result(timeout=30)
            tn = sched.observability()["tenants"]["a"]
            assert tn["admitted"] == 2
            assert tn["completed"] == 2
        finally:
            assert sched.close()

    def test_pq_route_gets_rerank_first_rung(self):
        eng = FakeEngine(d=D)
        pq_eng = FakeEngine(d=D)
        pq_eng.index = SimpleNamespace(
            L=np.zeros((2, D), np.float32), version=0, size=1000,
            n_shards=1, nprobe=8, cap=16, rerank_depth=64)
        sched = _scheduler(eng, FakeClock(), degrade=True)
        try:
            sched.add_route("pq", pq_eng)
            _, ctrl = sched._resolve_route("pq")
            assert ctrl.ladder[1] == {"rerank": 32}
        finally:
            assert sched.close()


# -- parity with the reference scheduler -------------------------------------

def _index_pair(base, L, G, n_clusters=4, nprobe=4):
    """(reference index, the port's over the same arrays, on the CPU)."""
    a = np.asarray
    if base == "exact":
        j = JaxExactIndex.build(jnp.asarray(L), jnp.asarray(G))
        return j, exact_index_from_jax(a(j.L), a(j.gp), a(j.gn), device=CPU)
    if base == "ivf":
        j = JaxIVFIndex.build(jnp.asarray(L), jnp.asarray(G),
                              n_clusters=n_clusters, nprobe=nprobe, seed=0)
        return j, ivf_index_from_jax(
            a(j.L), a(j.centroids), a(j.gp_pad), a(j.gn_pad), a(j.ids_pad),
            j.cap, j.n_clusters, j.nprobe, j.n_rows, device=CPU)
    j = JaxIVFPQIndex.build(jnp.asarray(L), jnp.asarray(G),
                            n_clusters=n_clusters, nprobe=nprobe,
                            n_subspaces=4, bits=4, rerank_depth=50, seed=0)
    return j, ivfpq_index_from_jax(
        a(j.L), a(j.centroids), a(j.pq.codebooks), j.pq.dim,
        a(j.codes_pad), a(j.t_pad), a(j.ids_pad), a(j.gp_full),
        a(j.gn_full), j.cap, j.n_clusters, j.nprobe, j.n_rows,
        rerank_depth=j.rerank_depth, device=CPU)


def _gated(engine_cls):
    """``engine_cls`` with a test gate in front of ``search`` and a record
    of every call's query rows and knobs."""

    class Gated(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gate = threading.Event()
            self.gate.set()
            self.entered = threading.Event()
            self.calls = []

        def search(self, queries, k_top=None, *, span=None, **topk_kw):
            self.entered.set()
            assert self.gate.wait(timeout=60), "test gate never opened"
            self.calls.append((np.array(queries, np.float32),
                               dict(topk_kw)))
            return super().search(queries, k_top, span=span, **topk_kw)

    return Gated


def _drive(sched_cls, expired_cls, clock, engine, queries, classes):
    """One request sequence on FakeClock: a plug parks the worker, the
    requests queue in a fixed mix (two with deadlines that expire), the
    gate opens and the queue drains under pressure; then one request at
    a time, each after the restore window, until the ladder is back at
    level 0. Returns (outcomes by request, batches as request indices,
    knobs by batch, transitions)."""
    sched = sched_cls(engine, clock=clock, max_batch=3, max_wait_ms=0.0,
                      high_watermark=3, low_watermark=1,
                      degrade_window_s=0.0, restore_window_s=0.5)
    try:
        engine.gate.clear()
        engine.entered.clear()
        plug = sched.submit(queries[0], priority="mining")
        assert engine.entered.wait(timeout=60)
        futs = [sched.submit(q, priority=c,
                             deadline_s=0.05 if i in (3, 8) else None)
                for i, (q, c) in enumerate(zip(queries[1:13], classes))]
        clock.advance(0.06)
        engine.gate.set()
        results = [plug.result(timeout=60)]
        for f in futs:
            try:
                results.append(f.result(timeout=60))
            except expired_cls:
                results.append(None)
        for q in queries[13:]:
            clock.advance(0.6)
            results.append(sched.submit(q).result(timeout=60))
        assert sched.controller.level == 0
        transitions = [(t.t, t.level_from, t.level_to, t.queue_depth,
                        t.reason) for t in sched.controller.transitions]
    finally:
        assert sched.close()
    row_of = {q.tobytes(): i for i, q in enumerate(queries)}
    batches = [[row_of[row.tobytes()] for row in qs]
               for qs, _ in engine.calls]
    knobs = [kw for _, kw in engine.calls]
    return results, batches, knobs, transitions


@pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq"])
def test_scheduler_parity_with_reference(base):
    """One request sequence through both packages' schedulers, over
    engines carried across with ``convert``: the same batches, knobs,
    transitions and outcomes; answers with ids equal and distances
    within the factored-distance rule (module docstring)."""
    rng = np.random.RandomState(7)
    G = (3.0 * rng.randn(6, 16))[rng.randint(0, 6, 500)] \
        + 0.3 * rng.randn(500, 16)
    G = G.astype(np.float32)
    L = (0.3 * rng.randn(8, 16)).astype(np.float32)
    queries = (G[rng.randint(0, 500, 17)]
               + 0.05 * rng.randn(17, 16)).astype(np.float32)
    classes = ["interactive", "batch", "mining", "interactive", "batch",
               "interactive", "mining", "interactive", "batch",
               "interactive", "interactive", "batch"]
    jidx, pidx = _index_pair(base, L, G, n_clusters=8, nprobe=8)
    jeng = _gated(JaxRetrievalEngine)(jidx, k_top=5, cache_size=0)
    peng = _gated(RetrievalEngine)(pidx, k_top=5, cache_size=0)
    ref = _drive(JaxRequestScheduler, JaxDeadlineExceededError,
                 JaxFakeClock(), jeng, queries, classes)
    got = _drive(RequestScheduler, DeadlineExceededError, FakeClock(), peng,
                 queries, classes)
    assert got[1] == ref[1], "batches differ"
    assert got[2] == ref[2], "knobs differ"
    assert got[3] == ref[3], "transitions differ"
    if base != "exact":
        assert any(k for k in got[2]), "the ladder never stepped down"
        assert len(got[3]) >= 2
    assert sum(r is None for r in got[0]) == 2
    gn = np.sum(np.square(G.astype(np.float64) @ L.T), axis=1)
    qn = np.sum(np.square(queries.astype(np.float64) @ L.T), axis=1)
    for i, (a, b) in enumerate(zip(got[0], ref[0])):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[1], b[1])
            tol = 1e-5 + 1e-5 * (qn[i] + gn[b[1]])
            assert (np.abs(a[0] - b[0]) <= tol).all()
