"""The port's hard-pair miner and mined pair stream held against the JAX
reference, on the CPU.

The miner: one L, feature table and label table (made from a seed with
numpy) go through ``repro.mining.HardPairMiner`` over a reference index
and ``repro_torch.mining.HardPairMiner`` over the same index carried
across (``convert.exact_index_from_jax``, ``ivf_index_from_jax``,
``mutable_index_from_jax`` with tombstones and an upserted id past the
label table). The mined ``pairs`` must be equal, and so must every count
in ``stats`` (all but the timings ``mine_busy_s`` and ``engine_qps``),
under each filter setting: semi-hard on and off, the nearest-negative
fallback on and off, ``band_pct`` 50, no negatives, no positives. Mining
through the port's ``RequestScheduler`` equals direct mining; anchors a
front end sheds are counted and mine nothing. The reference's own filter
cases (tests/test_mining.py) run on the port.

The stream: both packages' ``MinedPairSource`` over one pool give, batch
by batch, the same a, b and sim indices, and xs / ys bit-equal to the
reference's ``jnp`` arrays, across the curriculum's warm-up, ramp and
plateau and a pool swapped in mid-stream.
"""

from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data import pairs as jax_pairs
from repro.mining import CurriculumSchedule as JaxSchedule
from repro.mining import HardPairMiner as JaxMiner
from repro.mining import MinedPairSource as JaxSource
from repro.mining import MinerConfig as JaxMinerConfig
from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import IVFIndex as JaxIVFIndex
from repro.serve import MutableIndex as JaxMutableIndex
from repro.serve import RetrievalEngine as JaxEngine

from repro_torch.convert import (exact_index_from_jax, ivf_index_from_jax,
                                 mutable_index_from_jax)
from repro_torch.mining import (CurriculumSchedule, HardPairMiner,
                                MinedPairSource, MinerConfig, MiningResult)
from repro_torch.serve import (ExactIndex, RequestScheduler,
                               RetrievalEngine)

from test_torch_mutable import _jax_state

CPU = "cpu"
D = 16
# every stats entry but the two timings must be equal
TIMED = ("mine_busy_s", "engine_qps")


def _blobs(n=600, d=D, c=6, noise=0.3, seed=0):
    cfg = jax_pairs.PairDatasetConfig(n_samples=n, feat_dim=d, n_classes=c,
                                      kind="class_blobs", noise=noise,
                                      seed=seed)
    return jax_pairs.make_features(cfg)


def _L(seed=3, d_out=8, d=D):
    return (0.4 * np.random.RandomState(seed).randn(d_out, d)) \
        .astype(np.float32)


def _index_pair(kind, x, L):
    """(reference index, the port's in the same state)."""
    if kind == "exact":
        j = JaxExactIndex.build(L, x)
        return j, exact_index_from_jax(np.asarray(j.L), np.asarray(j.gp),
                                       np.asarray(j.gn), device=CPU)
    if kind == "ivf":
        j = JaxIVFIndex.build(L, x, n_clusters=8, nprobe=4)
        return j, ivf_index_from_jax(
            np.asarray(j.L), np.asarray(j.centroids), np.asarray(j.gp_pad),
            np.asarray(j.gn_pad), np.asarray(j.ids_pad), j.cap,
            j.n_clusters, j.nprobe, j.n_rows, device=CPU)
    # mutable: 30 tombstones in the base, 20 rows re-upserted, and 5 new
    # rows whose ids lie past the label table (the filter must skip them)
    j = JaxMutableIndex.build(L, x, retain_raw=True, auto_compact_delta=0,
                              auto_compact_dead=0)
    rng = np.random.RandomState(7)
    j.delete(np.arange(0, 60, 2))
    j.upsert(x[100:120] + 0.01 * rng.randn(20, x.shape[1])
             .astype(np.float32), ids=np.arange(100, 120))
    j.upsert(x[rng.randint(0, len(x), 5)])
    assert j.live_ids().max() >= len(x)
    return j, mutable_index_from_jax(_jax_state(j), device=CPU)


FILTERS = {
    "default": {},
    "semi_hard_off": dict(semi_hard=False),
    "fallback_off": dict(fallback_nearest=False),
    "band_pct_50": dict(band_pct=50.0, margin=2.0),
    "no_negatives": dict(max_negatives=0, max_positives=3),
    "no_positives": dict(max_negatives=3, max_positives=0),
}


def _assert_same_result(r_port, r_ref):
    for key in ("a", "b", "sim"):
        np.testing.assert_array_equal(r_port.pairs[key], r_ref.pairs[key])
    assert r_port.pairs["sim"].dtype == np.int32
    assert set(r_port.stats) == set(r_ref.stats)
    for key in r_ref.stats:
        if key not in TIMED:
            assert r_port.stats[key] == r_ref.stats[key], key


@pytest.mark.parametrize("kind", ["exact", "ivf", "mutable"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_mined_pairs_equal_reference(kind, filt):
    x, y = _blobs(noise=1.0)
    L = _L()
    j_index, p_index = _index_pair(kind, x, L)
    kw = dict(k_neighbors=12, max_negatives=2, max_positives=2)
    kw.update(FILTERS[filt])
    j_miner = JaxMiner(JaxEngine(j_index, k_top=13), x, y,
                       JaxMinerConfig(**kw), warmup=False, query_batch=64)
    p_miner = HardPairMiner(RetrievalEngine(p_index, k_top=13), x, y,
                            MinerConfig(**kw), warmup=False, query_batch=64)
    for seed in (0, 1):
        r_ref = j_miner.mine(n_queries=150, seed=seed)
        r_port = p_miner.mine(n_queries=150, seed=seed)
        assert r_ref.n_pairs > 0
        _assert_same_result(r_port, r_ref)
    # explicit anchors, and all of them (the dense distinct_draws path)
    qid = np.arange(0, len(x), 3)
    _assert_same_result(p_miner.mine(query_ids=qid),
                        j_miner.mine(query_ids=qid))
    _assert_same_result(p_miner.mine(n_queries=len(x), seed=4),
                        j_miner.mine(n_queries=len(x), seed=4))


def test_tensor_feature_table_mines_the_same_pairs():
    """The table as a tensor (as the closed loop passes it) and as numpy
    give the same pairs; the miner keeps the caller's tensor."""
    x, y = _blobs()
    engine = RetrievalEngine(ExactIndex.build(_L(), x, device=CPU),
                             k_top=11)
    table = torch.from_numpy(x)
    m_t = HardPairMiner(engine, table, torch.from_numpy(y),
                        MinerConfig(k_neighbors=10), warmup=False)
    m_n = HardPairMiner(engine, x, y, MinerConfig(k_neighbors=10),
                        warmup=False)
    assert m_t.features.data_ptr() == table.data_ptr()
    _assert_same_result(m_t.mine(n_queries=100, seed=2),
                        m_n.mine(n_queries=100, seed=2))


def test_index_wrapped_in_an_engine_and_warmed():
    x, y = _blobs(n=200)
    m = HardPairMiner(ExactIndex.build(_L(), x, device=CPU), x, y,
                      MinerConfig(k_neighbors=10))
    assert isinstance(m.engine, RetrievalEngine)
    assert m.engine.k_top == 11
    assert m.mine(n_queries=20).n_pairs > 0


def test_miner_errors_match_reference():
    x, y = _blobs(n=120)
    for bad in (dict(k_neighbors=1), dict(band_pct=0.0),
                dict(band_pct=101.0), dict(max_negatives=-1)):
        with pytest.raises(ValueError):
            JaxMinerConfig(**bad)
        with pytest.raises(ValueError):
            MinerConfig(**bad)
    engine = RetrievalEngine(ExactIndex.build(_L(), x, device=CPU))
    with pytest.raises(ValueError, match="labels"):
        HardPairMiner(engine, x, y[:-1], warmup=False)
    m = HardPairMiner(engine, x, y, warmup=False)
    with pytest.raises(ValueError, match="query_ids or n_queries"):
        m.mine()
    with pytest.raises(ValueError, match="n_queries must be >= 1"):
        m.mine(n_queries=0)
    with pytest.raises(ValueError, match="empty"):
        m.mine(query_ids=[])


# -- the front end ------------------------------------------------------------

def test_frontend_routed_mining_equals_direct_and_reference():
    """Mining through the port's scheduler ``mining`` class gives the
    direct path's pairs, which are the reference's."""
    x, y = _blobs(n=300)
    k, L = 10, _L()
    j_index, p_index = _index_pair("exact", x, L)
    cfg = dict(k_neighbors=k, max_negatives=2, max_positives=2)
    engine = RetrievalEngine(p_index, k_top=k + 1)
    r_direct = HardPairMiner(engine, x, y, MinerConfig(**cfg),
                             warmup=False).mine(n_queries=64, seed=3)
    sched = RequestScheduler(engine, max_wait_ms=0.0, degrade=False)
    try:
        r_routed = HardPairMiner(engine, x, y, MinerConfig(**cfg),
                                 warmup=False, frontend=sched) \
            .mine(n_queries=64, seed=3)
        mining = sched.observability()["classes"]["mining"]
    finally:
        sched.close()
    assert r_routed.stats["n_dropped"] == 0
    assert mining["completed"] == 64
    r_ref = JaxMiner(JaxEngine(j_index, k_top=k + 1), x, y,
                     JaxMinerConfig(**cfg), warmup=False) \
        .mine(n_queries=64, seed=3)
    for key in ("a", "b", "sim"):
        np.testing.assert_array_equal(r_routed.pairs[key],
                                      r_direct.pairs[key])
        np.testing.assert_array_equal(r_routed.pairs[key], r_ref.pairs[key])


def test_frontend_gets_host_rows_from_a_tensor_table():
    """The scheduler takes host rows: a tensor table is pulled back
    before the per-anchor submits."""
    x, y = _blobs(n=200)
    engine = RetrievalEngine(ExactIndex.build(_L(), x, device=CPU),
                             k_top=11)
    sched = RequestScheduler(engine, max_wait_ms=0.0, degrade=False)
    try:
        r = HardPairMiner(engine, torch.from_numpy(x), y,
                          MinerConfig(k_neighbors=10), warmup=False,
                          frontend=sched).mine(n_queries=32, seed=1)
    finally:
        sched.close()
    r_direct = HardPairMiner(engine, x, y, MinerConfig(k_neighbors=10),
                             warmup=False).mine(n_queries=32, seed=1)
    _assert_same_result(r, r_direct)


class _Shedding:
    """Every 2nd submit rejected at admission, like a full mining queue;
    every 3rd admitted one fails in its batch."""

    def __init__(self, engine):
        self.engine, self.n = engine, 0

    def submit(self, row, k_top, priority):
        assert priority == "mining" and isinstance(row, np.ndarray)
        self.n += 1
        if self.n % 2 == 0:
            raise RuntimeError("queue full")
        fut = Future()
        if self.n % 3 == 0:
            fut.set_exception(RuntimeError("batch failed"))
        else:
            fut.set_result(self.engine.search(row, k_top=k_top))
        return fut


def test_shed_anchors_mine_nothing_and_are_counted():
    x, y = _blobs(n=300)
    engine = RetrievalEngine(ExactIndex.build(_L(), x, device=CPU),
                             k_top=11)
    cfg = MinerConfig(k_neighbors=10, max_negatives=2, max_positives=2)
    front = _Shedding(engine)
    m = HardPairMiner(engine, x, y, cfg, warmup=False, frontend=front)
    res = m.mine(n_queries=64, seed=3)
    served = [n for n in range(1, 65) if n % 2 and n % 3]
    assert res.stats["n_dropped"] == 64 - len(served)
    assert res.n_pairs > 0
    assert (res.pairs["a"] >= 0).all() and (res.pairs["b"] >= 0).all()
    # the survivors mined what direct mining gives for the same anchors
    anchors = np.random.RandomState(3)
    qid = jax_pairs.distinct_draws(anchors, len(x), 64)
    kept = qid[np.asarray(served) - 1]
    assert set(res.pairs["a"]) <= set(kept)
    assert m.registry.counter("miner_dropped_total").value() == \
        res.stats["n_dropped"]


def test_oversized_neighborhood_rejected_with_frontend():
    x, y = _blobs(n=100)
    engine = RetrievalEngine(ExactIndex.build(_L(), x, device=CPU), k_top=5)
    sched = RequestScheduler(engine, max_wait_ms=0.0, degrade=False)
    try:
        with pytest.raises(ValueError, match="k_top"):
            HardPairMiner(engine, x, y, MinerConfig(k_neighbors=10),
                          warmup=False, frontend=sched)
    finally:
        sched.close()


# -- the reference's filter cases on the port ---------------------------------

def _miner(x, y, cfg=None, L=None):
    if L is None:
        L = np.eye(x.shape[1], dtype=np.float32)
    engine = RetrievalEngine(ExactIndex.build(L, x, device=CPU))
    return HardPairMiner(engine, x, y, cfg, warmup=False)


def test_label_correctness():
    x, y = _blobs()
    res = _miner(x, y, MinerConfig(k_neighbors=15, max_negatives=2,
                                   max_positives=2)).mine(n_queries=200)
    p = res.pairs
    neg, pos = p["sim"] == 0, p["sim"] == 1
    assert res.n_pairs > 0
    assert (y[p["a"][neg]] != y[p["b"][neg]]).all()
    assert (y[p["a"][pos]] == y[p["b"][pos]]).all()
    assert (p["a"] != p["b"]).all()
    assert res.stats["n_hard_neg"] + res.stats["n_hard_pos"] == res.n_pairs


def test_positives_are_knn_violations():
    x, y = _blobs(noise=1.5)
    k = 10
    m = _miner(x, y, MinerConfig(k_neighbors=k, max_negatives=0,
                                 max_positives=3))
    p = m.mine(n_queries=150, seed=1).pairs
    assert len(p["a"]) > 0
    _, nbr = m.engine.search(x[p["a"]], k_top=k + 1)
    for row, b in zip(nbr, p["b"]):
        assert b not in row


def test_semi_hard_band_respects_margin():
    x, y = _blobs(n=400, noise=1.0)
    k, margin = 20, 2.0
    m = _miner(x, y, MinerConfig(k_neighbors=k, margin=margin,
                                 semi_hard=True, fallback_nearest=False,
                                 max_negatives=3, max_positives=0))
    res = m.mine(n_queries=150)
    p = res.pairs
    assert res.n_pairs > 0 and res.stats["n_fallback_neg"] == 0
    d_all, i_all = m.engine.search(x[p["a"]], k_top=k + 1)
    for row_d, row_i, a, b in zip(d_all, i_all, p["a"], p["b"]):
        keep = row_i != a
        row_d, row_i = row_d[keep], row_i[keep]
        same = y[row_i] == y[a]
        d_pos = row_d[same].max() if same.any() else 0.0
        d_neg = float(np.sum((x[a] - x[b]) ** 2))
        assert d_pos <= d_neg + 1e-4
        assert d_neg < d_pos + margin + 1e-4


def test_fallback_covers_out_of_band_anchors():
    x, y = _blobs(n=300, noise=0.05)
    kw = dict(k_neighbors=80, margin=1e-6, max_negatives=1,
              max_positives=0)
    r_strict = _miner(x, y, MinerConfig(fallback_nearest=False, **kw)) \
        .mine(n_queries=100)
    r_fb = _miner(x, y, MinerConfig(fallback_nearest=True, **kw)) \
        .mine(n_queries=100)
    assert r_fb.stats["n_hard_neg"] > r_strict.stats["n_hard_neg"]
    assert r_fb.stats["n_fallback_neg"] > 0


def test_engine_qps_and_registry_counters():
    x, y = _blobs(n=300)
    m = _miner(x, y)
    res = m.mine(n_queries=64)
    assert isinstance(res, MiningResult)
    assert res.stats["engine_qps"] > 0 and res.stats["mine_busy_s"] > 0
    assert m.engine.stats()["n_queries"] >= 64
    r = m.registry
    assert r.counter("miner_mines_total").value() == 1
    assert r.counter("miner_queries_total").value() == 64
    pairs = r.counter("miner_pairs_total", labelnames=("kind",))
    assert pairs.total() == res.n_pairs


# -- the stream ---------------------------------------------------------------

SCHEDULES = [dict(warmup_steps=1, ramp_steps=2, max_mined_frac=0.5),
             dict(warmup_steps=0, ramp_steps=0, max_mined_frac=1.0),
             dict(warmup_steps=2, ramp_steps=3, max_mined_frac=0.0)]


def _pool(x, y):
    return JaxMiner(JaxEngine(JaxExactIndex.build(_L(), x)), x, y,
                    JaxMinerConfig(k_neighbors=10, max_negatives=2,
                                   max_positives=2),
                    warmup=False).mine(n_queries=120, seed=0)


def _rows_to_ids(x, rows):
    """Row indices of ``rows`` in the table (its rows are distinct)."""
    where = {r.tobytes(): i for i, r in enumerate(x)}
    return np.array([where[r.tobytes()] for r in np.asarray(rows)])


def _assert_same_batch(x, bp, bj):
    for key in ("xs", "ys"):
        assert bp[key].dtype == torch.float32
        np.testing.assert_array_equal(bp[key].numpy(), np.asarray(bj[key]))
        np.testing.assert_array_equal(_rows_to_ids(x, bp[key].numpy()),
                                      _rows_to_ids(x, np.asarray(bj[key])))
    assert bp["sim"].dtype == torch.int32
    np.testing.assert_array_equal(bp["sim"].numpy(), np.asarray(bj["sim"]))


@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
@pytest.mark.parametrize("balanced", [True, False])
def test_stream_batches_equal_reference(sched, balanced):
    x, y = _blobs(n=400)
    assert len(np.unique(x, axis=0)) == len(x)
    pool = _pool(x, y)
    j = JaxSource(x, y, JaxSchedule(**SCHEDULES[sched]),
                  balanced_uniform=balanced)
    p = MinedPairSource(x, y, CurriculumSchedule(**SCHEDULES[sched]),
                        balanced_uniform=balanced, device=CPU)
    j.set_pool(pool)
    p.set_pool(pool)
    sj, sp = j.worker_streams(3, 32, seed=5), p.worker_streams(3, 32, seed=5)
    for step in range(6):
        if step == 3:       # a fresh pool, mid-stream, in both
            fresh = _pool(x[::-1].copy(), y[::-1].copy())
            j.set_pool(fresh)
            p.set_pool(fresh)
            assert p.pool_version == j.pool_version == 2
        for a, b in zip(sp, sj):
            _assert_same_batch(x, next(a), next(b))
    assert p.pool_size == j.pool_size


def test_schedule_matches_reference():
    for kw in SCHEDULES + [dict(), dict(warmup_steps=5, ramp_steps=7,
                                        max_mined_frac=0.3)]:
        for step in range(20):
            assert CurriculumSchedule(**kw).mined_frac(step) == \
                JaxSchedule(**kw).mined_frac(step)
    for bad in (dict(max_mined_frac=1.5), dict(max_mined_frac=-0.1),
                dict(warmup_steps=-1), dict(ramp_steps=-1)):
        with pytest.raises(ValueError):
            JaxSchedule(**bad)
        with pytest.raises(ValueError):
            CurriculumSchedule(**bad)


def test_stream_pool_validation_and_placement():
    x, y = _blobs(n=100)
    table = torch.from_numpy(x)
    src = MinedPairSource(table, y, device=CPU)
    assert src.features.data_ptr() == table.data_ptr()   # f32: no copy
    assert src.pool_size == 0 and src.pool_version == 0
    with pytest.raises(ValueError, match="same-shape"):
        src.set_pool({"a": np.arange(3), "b": np.arange(2),
                      "sim": np.zeros(3)})
    with pytest.raises(ValueError, match="out of range"):
        src.set_pool({"a": np.array([0]), "b": np.array([100]),
                      "sim": np.array([0])})
    src.set_pool({"a": torch.tensor([0]), "b": torch.tensor([1]),
                  "sim": torch.tensor([0])})
    assert src.pool_size == 1 and src.pool_version == 1
    (stream,) = src.worker_streams(1, 16, seed=0)
    b = next(stream)
    assert b["xs"].shape == (16, D) and b["xs"].device.type == "cpu"
    assert jnp.asarray(b["sim"].numpy()).dtype == jnp.int32
