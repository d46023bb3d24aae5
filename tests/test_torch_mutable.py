"""The port's mutable gallery held against the JAX reference, on the CPU.

Both packages start from one state: a reference ``MutableIndex`` is
built from numpy inputs made from a seed and carried across with
``repro_torch.convert.mutable_index_from_jax``. The same op sequence
(upsert, update, delete, compaction by fold and by spill rebuild,
``swap_metric`` at the same and at a changed rank) then runs on both,
and after each step the ids are equal, the distances within atol + rtol
* (||qp||² + ||gp||²) with rtol = atol = 1e-5 (the repo's rule for the
factored distance, whose f32 rounding scales with the operands' norms,
not with their cancelling difference), and the counters, sizes and live
ids equal; after a fold the
segment ids (and the IVFPQ codes) equal. The reference's own properties
(match a rebuild, compaction keeps answers, a random op sequence,
version bumps, auto-compaction, reused ids, the errors) run on the port,
then the engine repair (``stats()`` keys, ``_adopt_index``), the engine
and batcher over a mutable index, and the launcher's ``--mutable``,
``--churn`` and ``--snapshot-dir``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import IVFIndex as JaxIVFIndex
from repro.serve import IVFPQIndex as JaxIVFPQIndex
from repro.serve import MutableIndex as JaxMutableIndex
from repro.serve import RetrievalEngine as JaxRetrievalEngine

from repro_torch.convert import (ivf_index_from_jax, ivfpq_index_from_jax,
                                 mutable_index_from_jax)
from repro_torch.launch import serve_retrieval
from repro_torch.obs import index_memory
from repro_torch.serve import (ExactIndex, IVFIndex, MicroBatcher,
                               MutableIndex, RetrievalEngine, recall_at_k)
from repro_torch.serve.mutable import _DELTA_MIN_CAP

CPU = "cpu"
D, K = 24, 12
TOL = dict(rtol=1e-5, atol=1e-5)
# ivf / ivfpq at nprobe == n_clusters; the IVFPQ rerank covers every
# probed row, so its answers are exact even after a spill rebuild
# retrains the codebooks (which the two packages seed differently)
BASE_KW = {"exact": {},
           "ivf": dict(n_clusters=8, nprobe=8),
           "ivfpq": dict(n_clusters=8, nprobe=8, n_subspaces=4, bits=4,
                         rerank_depth=10_000)}


def _data(M=400, seed=0, n_blobs=12):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(n_blobs, D).astype(np.float32)
    G = centers[rng.randint(0, n_blobs, M)] \
        + 0.3 * rng.randn(M, D).astype(np.float32)
    L = (0.3 * rng.randn(K, D)).astype(np.float32)
    q = G[rng.randint(0, M, 9)] + 0.1 * rng.randn(9, D).astype(np.float32)
    return L, G, q, rng


def _jax_state(mut):
    """A reference MutableIndex's state in ``mutable_index_from_jax``'s
    form."""
    b, a = mut.base, np.asarray
    if isinstance(b, JaxExactIndex):
        kind, base = "exact", dict(L_np=a(b.L), gp_np=a(b.gp), gn_np=a(b.gn))
    else:
        seg = dict(L_np=a(b.L), centroids_np=a(b.centroids),
                   ids_pad_np=a(b.ids_pad), cap=b.cap,
                   n_clusters=b.n_clusters, nprobe=b.nprobe, n_rows=b.n_rows)
        if isinstance(b, JaxIVFPQIndex):
            kind, base = "ivfpq", dict(
                seg, codebooks_np=a(b.pq.codebooks), dim=b.pq.dim,
                codes_pad_np=a(b.codes_pad), t_pad_np=a(b.t_pad),
                gp_full_np=b.gp_full, gn_full_np=b.gn_full,
                rerank_depth=b.rerank_depth, store=b.store)
        else:
            kind, base = "ivf", dict(seg, gp_pad_np=a(b.gp_pad),
                                     gn_pad_np=a(b.gn_pad))
    return dict(
        base_type=kind, base=base, base_ids=mut.base_ids,
        dead_base=mut.dead_base, delta_gp=mut.delta_gp,
        delta_gn=mut.delta_gn, delta_ids=mut.delta_ids,
        dead_delta=mut.dead_delta, raw_base=mut.raw_base,
        raw_delta=mut.raw_delta, next_id=mut._next_id, version=mut.version,
        n_upserts=mut.n_upserts, n_deletes=mut.n_deletes,
        n_compactions=mut.n_compactions, n_rebuilds=mut.n_rebuilds,
        n_swaps=mut.n_swaps, base_kwargs=mut._base_kwargs,
        auto_compact_delta=mut.auto_compact_delta,
        auto_compact_dead=mut.auto_compact_dead)


def _pair(base="exact", M=400, seed=0):
    """(reference mutable, the port's in the same state, queries, rng)."""
    L, G, q, rng = _data(M=M, seed=seed)
    jm = JaxMutableIndex.build(L, G, base=base, retain_raw=True,
                               auto_compact_delta=0, auto_compact_dead=0,
                               **BASE_KW[base])
    return jm, mutable_index_from_jax(_jax_state(jm), device=CPU), q, rng


def _assert_close_dists(mut, q, ids, d, d_ref):
    """|d - d_ref| <= atol + rtol * (||qp||² + ||gp||²), entry by entry."""
    _, gn, live, _ = mut._live_state()
    qp = q @ mut.L.numpy().T
    qn = np.sum(qp.astype(np.float64) ** 2, axis=1)
    gn = gn.numpy()[np.searchsorted(live, ids)]
    tol = TOL["atol"] + TOL["rtol"] * (qn[:, None] + gn)
    err = np.abs(d.astype(np.float64) - d_ref)
    assert (err <= tol).all(), f"max err {err.max():.3e}"


def _assert_same(jm, pm, q, k_top=10, **kw):
    d_j, i_j = jm.topk(jnp.asarray(q), k_top, **kw)
    d_p, i_p = pm.topk(torch.from_numpy(q), k_top, **kw)
    assert i_p.dtype == torch.int64 and d_p.dtype == torch.float32
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    _assert_close_dists(pm, q, i_p.numpy(), d_p.numpy(), np.asarray(d_j))
    for attr in ("version", "size", "tombstones", "delta_rows",
                 "n_compactions", "n_rebuilds", "n_swaps", "_next_id"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    np.testing.assert_array_equal(pm.live_ids(), jm.live_ids())
    np.testing.assert_array_equal(pm.base_ids, jm.base_ids)


def _assert_same_segments(jm, pm):
    np.testing.assert_array_equal(pm.base.ids_pad.numpy(),
                                  np.asarray(jm.base.ids_pad))
    if isinstance(pm.base, IVFIndex):
        np.testing.assert_allclose(pm.base.gp_pad.numpy(),
                                   np.asarray(jm.base.gp_pad), **TOL)
    else:
        np.testing.assert_array_equal(pm.base.codes_pad.numpy(),
                                      np.asarray(jm.base.codes_pad))
        np.testing.assert_allclose(pm.base.t_pad.numpy(),
                                   np.asarray(jm.base.t_pad), **TOL)


# -- the shared op sequence against the reference ---------------------------

@pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq"])
def test_op_sequence_matches_reference_step_by_step(base):
    jm, pm, q, rng = _pair(base)
    _assert_same(jm, pm, q)

    rows = rng.randn(37, D).astype(np.float32)
    new_j, new_p = jm.upsert(rows), pm.upsert(rows)
    np.testing.assert_array_equal(new_p, new_j)
    _assert_same(jm, pm, q)

    for batch in (np.arange(25), new_j[:5]):       # base, delta tombstones
        jm.delete(batch)
        pm.delete(batch)
        _assert_same(jm, pm, q)

    upd = rng.randn(4, D).astype(np.float32)       # update: existing ids
    ids = np.asarray([30, 31, *new_j[5:7]])
    jm.upsert(upd, ids=ids)
    pm.upsert(upd, ids=ids)
    _assert_same(jm, pm, q)
    _assert_same(jm, pm, q, k_top=jm.size)         # every live row

    assert jm.compact() and pm.compact()           # the fold
    assert pm.n_rebuilds == 0
    _assert_same(jm, pm, q)
    if base != "exact":
        _assert_same_segments(jm, pm)

    if base != "exact":                            # headroom spill
        free = pm.base.n_clusters * pm.base.cap - pm.base.size
        more = rng.randn(free + 50, D).astype(np.float32)
        jm.upsert(more)
        pm.upsert(more)
        _assert_same(jm, pm, q)
        jm.compact()
        pm.compact()
        assert pm.n_rebuilds == jm.n_rebuilds == 1
        _assert_same(jm, pm, q)

    jm.delete(np.arange(40, 50))
    pm.delete(np.arange(40, 50))
    for L_new in ((0.3 * rng.randn(K, D)).astype(np.float32),
                  (0.3 * rng.randn(K // 2, D)).astype(np.float32)):
        jm.swap_metric(L_new, block_rows=128)
        pm.swap_metric(L_new, block_rows=128)
        assert tuple(pm.L.shape) == L_new.shape
        _assert_same(jm, pm, q)
    more = rng.randn(9, D).astype(np.float32)      # upsert at the new rank
    jm.upsert(more)
    pm.upsert(more)
    _assert_same(jm, pm, q)


def test_convert_carries_the_state_bit_for_bit():
    jm, _, q, rng = _pair("ivf")
    jm.upsert(rng.randn(20, D).astype(np.float32))
    jm.delete(np.arange(7))
    pm = mutable_index_from_jax(_jax_state(jm), device=CPU)
    np.testing.assert_array_equal(pm.delta_gp.numpy(), jm.delta_gp)
    np.testing.assert_array_equal(pm.dead_base, jm.dead_base)
    np.testing.assert_array_equal(pm.raw_delta, jm.raw_delta)
    assert pm._loc == jm._loc and pm.version == jm.version
    _assert_same(jm, pm, q)


# -- the reference's properties on the port ----------------------------------

def _mut(base="exact", M=400, seed=0, **kw):
    L, G, q, rng = _data(M=M, seed=seed)
    mut = MutableIndex.build(L, G, base=base, retain_raw=True,
                             auto_compact_delta=0, auto_compact_dead=0,
                             device=CPU, **BASE_KW[base], **kw)
    return mut, G, q, rng


def _rebuild_topk(mut, queries, k_top):
    """Ground truth: a fresh ExactIndex over the live raw rows in
    ascending-external-id order."""
    ids = mut.live_ids()
    rows = np.stack([mut.raw_base[i] if kind == "base" else mut.raw_delta[i]
                     for kind, i in (mut._loc[int(e)] for e in ids)])
    ref = ExactIndex.build(mut.L, rows, device=CPU)
    d, i = ref.topk(torch.from_numpy(queries), k_top)
    return d.numpy(), ids[i.numpy()]


def _assert_matches_rebuild(mut, queries, k_top=10, **kw):
    d_ref, i_ref = _rebuild_topk(mut, queries, k_top)
    d, i = mut.topk(torch.from_numpy(queries), k_top, **kw)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq"])
def test_upsert_delete_update_matches_rebuild(base):
    mut, G, q, rng = _mut(base)
    _assert_matches_rebuild(mut, q)
    new_ids = mut.upsert(rng.randn(37, D).astype(np.float32))
    _assert_matches_rebuild(mut, q)
    mut.delete(np.arange(25))
    mut.delete(new_ids[:5])
    _assert_matches_rebuild(mut, q)
    mut.upsert(rng.randn(4, D).astype(np.float32),
               ids=np.asarray([30, 31, *new_ids[5:7]]))
    _assert_matches_rebuild(mut, q)
    assert mut.size == 400 + 37 - 25 - 5


@pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq"])
def test_compaction_preserves_answers(base):
    mut, G, q, rng = _mut(base)
    mut.upsert(rng.randn(30, D).astype(np.float32))
    mut.delete(np.arange(20))
    d_pre, i_pre = mut.topk(torch.from_numpy(q), 10)
    assert mut.compact()
    assert mut.delta_rows == 0 and mut.tombstones == 0
    d_post, i_post = mut.topk(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i_post.numpy(), i_pre.numpy())
    _assert_close_dists(mut, q, i_post.numpy(), d_post.numpy(),
                        d_pre.numpy())
    _assert_matches_rebuild(mut, q)
    assert not mut.compact()                        # clean -> no-op


@pytest.mark.parametrize("base", ["exact", "ivf"])
def test_random_sequence_property(base):
    mut, G, q, rng = _mut(base, M=300, seed=3)
    for step in range(12):
        op = rng.randint(0, 3)
        if op == 0:
            mut.upsert(rng.randn(rng.randint(1, 30), D).astype(np.float32))
        elif op == 1 and mut.size > 60:
            mut.delete(rng.choice(mut.live_ids(), rng.randint(1, 20),
                                  replace=False))
        else:
            pick = rng.choice(mut.live_ids(), rng.randint(1, 10),
                              replace=False)
            mut.upsert(rng.randn(len(pick), D).astype(np.float32), ids=pick)
        if step % 4 == 3:
            mut.compact()
        _assert_matches_rebuild(mut, q)


def test_ivf_headroom_fold_vs_spill_rebuild():
    mut, G, q, rng = _mut("ivf")
    cap_free = mut.base.n_clusters * mut.base.cap - mut.base.size
    mut.upsert(rng.randn(min(cap_free, 20), D).astype(np.float32))
    mut.compact()
    assert mut.n_compactions == 1 and mut.n_rebuilds == 0
    _assert_matches_rebuild(mut, q)
    mut.upsert(rng.randn(cap_free + 50, D).astype(np.float32))
    mut.compact()
    assert mut.n_rebuilds == 1
    _assert_matches_rebuild(mut, q)


def test_ivf_modest_nprobe_recall_under_churn():
    mut, G, q, rng = _mut("ivf", M=2000)
    mut.upsert(G[rng.randint(0, 2000, 100)]
               + 0.1 * rng.randn(100, D).astype(np.float32))
    mut.delete(rng.choice(2000, 100, replace=False))
    _, i_ref = _rebuild_topk(mut, q, 10)
    _, i_a = mut.topk(torch.from_numpy(q), 10, nprobe=4)
    assert recall_at_k(i_a.numpy(), i_ref) >= 0.9


def test_delta_buffer_grows_by_doubling_and_masks_its_pads():
    mut, G, q, rng = _mut()
    assert mut._delta_gp.shape[0] == _DELTA_MIN_CAP
    ids = mut.upsert(rng.randn(_DELTA_MIN_CAP + 1, D).astype(np.float32))
    assert mut._delta_gp.shape[0] == 2 * _DELTA_MIN_CAP
    mut.delete(ids[1:])
    mut.delete(np.arange(400))                 # only ids[0] stays live
    d, i = mut.topk(torch.from_numpy(q), 1)
    assert (i.numpy() == ids[0]).all() and torch.isfinite(d).all()
    mut.compact()
    assert mut._delta_gp.shape[0] == _DELTA_MIN_CAP and mut.size == 1


def test_version_bumps_per_batch():
    mut, G, q, rng = _mut()
    v0 = mut.version
    mut.upsert(rng.randn(3, D).astype(np.float32))
    assert mut.version == v0 + 1
    mut.delete(np.asarray([0, 1]))
    assert mut.version == v0 + 2
    mut.compact()
    assert mut.version == v0 + 3


def test_auto_compaction_thresholds():
    L, G, q, rng = _data()
    mut = MutableIndex.build(L, G, base="exact", auto_compact_delta=0.05,
                             auto_compact_dead=0, device=CPU)
    mut.upsert(rng.randn(30, D).astype(np.float32))  # > 5% of 400
    assert mut.n_compactions == 1 and mut.delta_rows == 0
    assert mut.base.size == 430
    mut = MutableIndex.build(L, G, base="exact", auto_compact_delta=0,
                             auto_compact_dead=0.05, device=CPU)
    mut.delete(np.arange(20))                        # not past 5%
    assert mut.n_compactions == 0
    mut.delete(np.asarray([20]))
    assert mut.n_compactions == 1 and mut.base.size == 379


def test_deleted_ids_are_reusable():
    mut, G, q, rng = _mut()
    mut.delete(np.asarray([7]))
    assert not mut.contains(7)
    mut.upsert(rng.randn(1, D).astype(np.float32), ids=np.asarray([7]))
    assert mut.contains(7)
    _assert_matches_rebuild(mut, q)


def _error(fn):
    """(exception type, message) of ``fn()``."""
    with pytest.raises((ValueError, KeyError, TypeError,
                        NotImplementedError)) as info:
        fn()
    return info.type, str(info.value)


_ERRORS = {
    "k_top 0": lambda m, q, r: m.topk(q, 0),
    "k_top > size": lambda m, q, r: m.topk(q, m.size + 1),
    "unknown id": lambda m, q, r: m.delete(np.asarray([10**9])),
    "duplicate delete": lambda m, q, r: m.delete(np.asarray([1, 1])),
    "negative id": lambda m, q, r: m.upsert(
        r.randn(2, D).astype(np.float32), ids=np.asarray([-1, 5])),
    "ids shape": lambda m, q, r: m.upsert(
        r.randn(2, D).astype(np.float32), ids=np.asarray([5])),
    "queries 1-D": lambda m, q, r: m.topk(q[0], 3),
    "swap d_in": lambda m, q, r: m.swap_metric(
        np.zeros((K, D + 1), np.float32)),
}


@pytest.mark.parametrize("name", list(_ERRORS))
def test_errors_match_reference(name):
    jm, pm, q, rng = _pair()
    fn = _ERRORS[name]
    j = _error(lambda: fn(jm, jnp.asarray(q), np.random.RandomState(0)))
    p = _error(lambda: fn(pm, torch.from_numpy(q), np.random.RandomState(0)))
    assert p == j


@pytest.mark.parametrize("name", ["nprobe 0", "rerank 0"])
def test_ivfpq_knob_errors_match_reference(name):
    jm, pm, q, _ = _pair("ivfpq")
    kw = {"nprobe 0": dict(nprobe=0), "rerank 0": dict(rerank=0)}[name]
    assert _error(lambda: pm.topk(torch.from_numpy(q), 3, **kw)) == \
        _error(lambda: jm.topk(jnp.asarray(q), 3, **kw))


def test_constructor_errors_match_reference():
    L, G, q, rng = _data()
    jb = JaxIVFPQIndex.build(L, jnp.asarray(G), rerank_depth=0,
                             **{k: v for k, v in BASE_KW["ivfpq"].items()
                                if k != "rerank_depth"})
    pb = ivfpq_index_from_jax(
        np.asarray(jb.L), np.asarray(jb.centroids),
        np.asarray(jb.pq.codebooks), jb.pq.dim, np.asarray(jb.codes_pad),
        np.asarray(jb.t_pad), np.asarray(jb.ids_pad), jb.gp_full, jb.gn_full,
        jb.cap, jb.n_clusters, jb.nprobe, jb.n_rows, rerank_depth=0,
        device=CPU)
    assert _error(lambda: MutableIndex(pb, L)) == \
        _error(lambda: JaxMutableIndex(jb, L))
    eb = ExactIndex.build(L, G, device=CPU)
    for bad in (np.arange(399), np.zeros(400)):
        assert _error(lambda: MutableIndex(eb, L, ids=bad)) == \
            _error(lambda: JaxMutableIndex(JaxExactIndex.build(
                jnp.asarray(L), jnp.asarray(G)), L, ids=bad))

    class FakeSharded:
        n_shards = 2
    with pytest.raises(NotImplementedError):
        MutableIndex(FakeSharded(), L)
    with pytest.raises(ValueError, match="unknown base"):
        MutableIndex.build(L, G, base="hnsw", device=CPU)


# -- metric hot-swap ---------------------------------------------------------

@pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq"])
def test_swap_matches_fresh_build(base):
    mut, G, q, rng = _mut(base)
    mut.upsert(rng.randn(15, D).astype(np.float32))
    mut.delete(np.arange(10))
    L2 = (0.3 * rng.randn(K, D)).astype(np.float32)
    v0 = mut.version
    timings = {}
    mut.swap_metric(L2, block_rows=128, timings=timings)
    assert mut.version > v0 and mut.n_swaps == 1
    assert set(timings) == {"host_to_device", "project", "rebuild"}
    np.testing.assert_array_equal(mut.L.numpy(), L2)
    _assert_matches_rebuild(mut, q)


def test_swap_to_a_changed_rank_then_upsert():
    mut, G, q, rng = _mut("ivf")
    L3 = (0.3 * rng.randn(K // 2, D)).astype(np.float32)
    mut.swap_metric(L3)
    assert mut.base.gp_pad.shape[1] == K // 2
    assert mut._delta_gp.shape[1] == K // 2
    mut.upsert(rng.randn(5, D).astype(np.float32))
    _assert_matches_rebuild(mut, q)


def test_swap_requires_retained_raw():
    L, G, q, rng = _data()
    mut = MutableIndex.build(L, G, base="exact", retain_raw=False,
                             device=CPU)
    with pytest.raises(ValueError, match="retain_raw"):
        mut.swap_metric(L)


# -- the engine repair and the engine over a mutable index -------------------

def _engine_pair(kind):
    """(reference engine, port engine, queries) over one index's arrays."""
    L, G, q, rng = _data()
    if kind == "mutable":
        jm, pm, q, rng = _pair("ivfpq")
        for m in (jm, pm):
            m.upsert(np.ones((3, D), np.float32))
            m.delete(np.asarray([4, 5]))
        return JaxRetrievalEngine(jm, k_top=5), RetrievalEngine(pm, k_top=5), q
    kw = {k: v for k, v in BASE_KW[kind].items() if k != "rerank_depth"}
    if kind == "ivf":
        jb = JaxIVFIndex.build(L, jnp.asarray(G), **kw)
        pb = ivf_index_from_jax(
            np.asarray(jb.L), np.asarray(jb.centroids), np.asarray(jb.gp_pad),
            np.asarray(jb.gn_pad), np.asarray(jb.ids_pad), jb.cap,
            jb.n_clusters, jb.nprobe, jb.n_rows, device=CPU)
    else:
        jb = JaxIVFPQIndex.build(L, jnp.asarray(G), **kw)
        pb = ivfpq_index_from_jax(
            np.asarray(jb.L), np.asarray(jb.centroids),
            np.asarray(jb.pq.codebooks), jb.pq.dim, np.asarray(jb.codes_pad),
            np.asarray(jb.t_pad), np.asarray(jb.ids_pad), jb.gp_full,
            jb.gn_full, jb.cap, jb.n_clusters, jb.nprobe, jb.n_rows,
            rerank_depth=jb.rerank_depth, device=CPU)
    return JaxRetrievalEngine(jb, k_top=5), RetrievalEngine(pb, k_top=5), q


@pytest.mark.parametrize("kind", ["ivf", "ivfpq", "mutable"])
def test_engine_stats_keys_match_reference(kind):
    ref, eng, q = _engine_pair(kind)
    _, i_ref = ref.search(q)
    _, i = eng.search(q)
    np.testing.assert_array_equal(i, i_ref)
    st, st_ref = eng.stats(), ref.stats()
    assert set(st) == set(st_ref)
    for key in ("delta_rows", "tombstones", "compactions",
                "code_bytes_per_row", "scan_impl", "gallery_size", "index"):
        assert st.get(key) == st_ref.get(key), key
    if "compression_ratio" in st_ref:
        assert st["compression_ratio"] == pytest.approx(
            st_ref["compression_ratio"])


def test_lifecycle_events_reach_the_engine_registry(tmp_path):
    from repro_torch.serve import save_index
    mut, G, q, rng = _mut(M=200)
    eng = RetrievalEngine(mut, k_top=5)
    assert mut.registry is eng.registry                 # adopted at init
    mut.upsert(rng.randn(4, D).astype(np.float32))
    mut.compact()
    mut.swap_metric((0.3 * rng.randn(K, D)).astype(np.float32))
    r = eng.registry
    assert len(r.events("index_compaction")) == 1
    assert len(r.events("index_swap_metric")) == 1
    other, _, _, _ = _mut("ivf", M=200, seed=1)
    eng.index = other                                   # swapped in
    snap = r.snapshot()                                 # collector adopts
    assert other.registry is r
    other.upsert(rng.randn(other.base.n_clusters * other.base.cap, D)
                 .astype(np.float32))
    other.compact()
    assert len(r.events("index_compaction")) == 2
    assert len(r.events("index_spill_rebuild")) == 1
    save_index(other, str(tmp_path))
    assert len(r.events("index_snapshot_save")) == 1
    counts = r.snapshot()["counters"]["index_lifecycle_total"]["values"]
    assert sum(counts.values()) == 5
    assert snap["gauges"]["index_gallery_rows"]["values"]


def test_cache_flush_on_each_mutation_batch():
    mut, G, q, rng = _mut(M=200)
    eng = RetrievalEngine(mut, k_top=5, cache_size=64)
    eng.search(q)
    eng.search(q)
    assert eng.stats()["cache_hits"] == 9
    mut.upsert(rng.randn(1, D).astype(np.float32))
    eng.search(q)
    st = eng.stats()
    assert st["cache_hits"] == 9 and st["cache_misses"] == 18
    mut.delete(np.asarray([0]))
    eng.search(q)
    assert eng.stats()["cache_misses"] == 27
    mut.compact()
    eng.search(q)
    assert eng.stats()["cache_misses"] == 36


def test_mutation_visible_through_engine():
    mut, G, q, rng = _mut(M=200)
    eng = RetrievalEngine(mut, k_top=5, cache_size=64)
    row = (10.0 + 0.01 * rng.randn(D)).astype(np.float32)
    (ext,) = mut.upsert(row).tolist()
    d, i = eng.search(row)
    assert i[0] == ext and i.dtype == np.int64
    mut.delete(np.asarray([ext]))
    d, i = eng.search(row)
    assert i[0] != ext


def test_stats_surface_lifecycle_counters():
    mut, G, q, rng = _mut(M=200)
    eng = RetrievalEngine(mut, k_top=5)
    mut.upsert(rng.randn(7, D).astype(np.float32))
    mut.delete(np.asarray([3]))
    st = eng.stats()
    assert (st["delta_rows"], st["tombstones"], st["compactions"]) == \
        (7, 1, 0)
    mem = index_memory(mut)
    assert mem["delta"] > 0 and mem["host_store"] == \
        mut.raw_base.nbytes + mut.raw_delta.nbytes
    mut.compact()
    assert eng.stats()["compactions"] == 1
    plain = RetrievalEngine(ExactIndex.build(mut.L, G, device=CPU), k_top=5)
    assert "delta_rows" not in plain.stats()
    assert "scan_impl" not in plain.stats()


def test_batcher_front_door():
    mut, G, q, rng = _mut(M=200)
    mut.upsert(rng.randn(6, D).astype(np.float32))
    mut.delete(np.asarray([2, 9]))
    eng = RetrievalEngine(mut, k_top=5)
    batcher = MicroBatcher(eng, max_batch=8, max_wait_ms=1.0)
    try:
        futs = [batcher.submit(qr) for qr in q]
        _, ref_i = mut.topk(torch.from_numpy(q), 5)
        for r, fut in enumerate(futs):
            _, i = fut.result(timeout=30)
            np.testing.assert_array_equal(i, ref_i[r].numpy())
    finally:
        assert batcher.close()


# -- the launcher ------------------------------------------------------------

def test_cli_mutable_churn_and_snapshot_restart(tmp_path, capsys):
    argv = ["--device", "cpu", "--train-steps", "0", "--gallery-size", "400",
            "--requests", "20", "--mutable", "--churn", "50",
            "--snapshot-dir", str(tmp_path / "snap")]
    serve_retrieval.main(argv)
    out = capsys.readouterr().out
    assert "built+projected" in out and "snapshot saved" in out
    assert "churn: +50 upserts" in out and "new ids reachable: True" in out
    assert "post-churn snapshot saved" in out
    serve_retrieval.main(argv)
    out = capsys.readouterr().out
    assert "loaded from snapshot" in out
    assert "index[MutableIndex]" in out


def test_cli_flag_errors(tmp_path):
    with pytest.raises(SystemExit):
        serve_retrieval.main(["--device", "cpu", "--churn", "5"])
    snap = str(tmp_path / "frozen")
    serve_retrieval.main(["--device", "cpu", "--train-steps", "0",
                          "--gallery-size", "200", "--requests", "4",
                          "--snapshot-dir", snap])
    with pytest.raises(SystemExit):            # frozen snapshot, --mutable
        serve_retrieval.main(["--device", "cpu", "--train-steps", "0",
                              "--gallery-size", "200", "--requests", "4",
                              "--snapshot-dir", snap, "--mutable"])
