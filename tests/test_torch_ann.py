"""The port's ANN serving slice (IVF and IVFPQ) held against the JAX
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Held equal: the k-means steps from the same start (assignments equal,
centroids within f32 rounding), the balanced assignment and the
cluster-major layout from the same assignment (arrays equal), the
product quantizer with the reference's codebooks carried across, and
``IVFIndex.topk`` / ``IVFPQIndex.topk`` over the reference index's own
arrays (``repro_torch.convert``): ids equal on the same queries. Then
the port's own builds (full probe equals ExactIndex; cap bounded; the
Lloyd objective does not rise), the scan knob, the engine and the CLI.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.serve import IVFIndex as JaxIVFIndex
from repro.serve import IVFPQIndex as JaxIVFPQIndex
from repro.serve import ProductQuantizer as JaxProductQuantizer
from repro.serve import ivf as jax_ivf

from repro_torch.convert import (ivf_index_from_jax, ivfpq_index_from_jax,
                                 pq_from_jax)
from repro_torch.kernels._dispatch import BIG
from repro_torch.launch import serve_retrieval
from repro_torch.obs import index_memory
from repro_torch.serve import (ExactIndex, IVFIndex, IVFPQIndex, MetricIndex,
                               ProductQuantizer, RetrievalEngine, recall_at_k)
from repro_torch.serve import ivf, scan

CPU = "cpu"
M, D, K, C, BLOBS = 600, 24, 12, 8, 10


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, copy=True)).to(dtype)


def _clustered(m=M, d=D, n_blobs=BLOBS, noise=0.3, seed=0):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(n_blobs, d).astype(np.float32)
    blob = rng.randint(0, n_blobs, m)
    pts = centers[blob] + noise * rng.randn(m, d).astype(np.float32)
    L = (rng.randn(K, d) / np.sqrt(d)).astype(np.float32)
    q = pts[rng.randint(0, m, 24)] + 0.1 * rng.randn(24, d).astype(np.float32)
    return L, pts.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _clustered()


@pytest.fixture(scope="module")
def projected(data):
    L, G, _ = data
    gp = np.asarray(G @ L.T, np.float32)
    return gp, np.sum(gp * gp, axis=1).astype(np.float32)


def _jax_start(seed, m):
    """The first farthest-point row the reference draws for ``seed``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, m))


# -- k-means ------------------------------------------------------------------

def test_assign_matches_reference(projected):
    gp, _ = projected
    cent = gp[::75][:C]
    a_j, md_j = jax_ivf._assign(jnp.asarray(gp), jnp.asarray(cent), 128)
    a, md = ivf._assign(_t(gp), _t(cent), 128)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(md.numpy(), np.asarray(md_j), rtol=1e-5,
                               atol=1e-4)


def test_farthest_init_matches_reference_from_the_same_start(projected):
    gp, _ = projected
    seeds_j = jax_ivf._farthest_init(jnp.asarray(gp), C,
                                     jax.random.PRNGKey(3))
    seeds = ivf._farthest_init(_t(gp), C, _jax_start(3, M))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(seeds_j))


def test_lloyd_matches_reference_from_the_same_cent0(projected):
    gp, _ = projected
    cent0 = gp[np.random.RandomState(1).choice(M, C, replace=False)]
    cent_j, obj_j = jax_ivf._lloyd(jnp.asarray(gp), jnp.asarray(cent0), 6,
                                   16384)
    cent, obj = ivf._lloyd(_t(gp), _t(cent0), 6)
    np.testing.assert_allclose(cent.numpy(), np.asarray(cent_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(obj.numpy(), np.asarray(obj_j), rtol=1e-5)
    a_j, _ = jax_ivf._assign(jnp.asarray(gp), cent_j, 16384)
    a, _ = ivf._assign(_t(gp), cent)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))


def test_empty_cluster_reseed():
    # 6 distinct rows tiled: 8 centroids from duplicated seeds leave
    # clusters empty; the reseed keeps every centroid a finite row mean
    # and every assignment in range (which tied row a reseed picks rests
    # on rounding noise in equal distances, so it is not compared)
    base = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    gp = np.tile(base, (40, 1))
    cent0 = gp[[0, 0, 1, 2, 2, 3, 4, 5]]
    cent, obj = ivf._lloyd(_t(gp), _t(cent0), 4, 64)
    assert np.isfinite(cent.numpy()).all() and np.isfinite(obj.numpy()).all()
    a, _ = ivf._assign(_t(gp), cent, 64)
    assert int(a.min()) >= 0 and int(a.max()) < 8
    assert len(np.unique(a.numpy())) == 6      # every distinct row served


@pytest.mark.parametrize("init", ["farthest", "start"])
def test_kmeans_projected(projected, init):
    gp, _ = projected
    if init == "start":                 # the reference's run, step by step
        cent_j, a_j, obj_j = jax_ivf.kmeans_projected(jnp.asarray(gp), C,
                                                      iters=5, seed=2)
        cent, a, obj = ivf.kmeans_projected(_t(gp), C, iters=5,
                                            start=_jax_start(2, M))
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
        np.testing.assert_allclose(cent.numpy(), np.asarray(cent_j),
                                   rtol=1e-5, atol=1e-5)
    else:                               # the port's own seeding
        cent, a, obj = ivf.kmeans_projected(_t(gp), C, iters=8, seed=1)
        again = ivf.kmeans_projected(_t(gp), C, iters=8, seed=1)
        assert torch.equal(a, again[1])
    assert cent.shape == (C, K) and a.shape == (M,)
    assert int(a.min()) >= 0 and int(a.max()) < C
    assert (np.diff(obj.numpy()) <= 1e-5).all(), "Lloyd objective rose"
    with pytest.raises(ValueError, match="n_clusters"):
        ivf.kmeans_projected(_t(gp[:5]), 6)


def _skewed(seed=0):
    """Rows with one dense blob, centroids and assignment that overflow."""
    rng = np.random.RandomState(seed)
    gp = np.concatenate([rng.randn(300, 6) * 0.2,
                         rng.randn(100, 6) * 3.0]).astype(np.float32)
    cent = gp[rng.choice(400, C, replace=False)]
    a, _ = jax_ivf._assign(jnp.asarray(gp), jnp.asarray(cent), 4096)
    return gp, cent, np.asarray(a)


def test_balance_assign_matches_reference():
    gp, cent, a = _skewed()
    cap = jax_ivf_capacity = ivf.capacity(400, C, 1.25)
    assert np.bincount(a, minlength=C).max() > cap      # it has to spill
    ref = jax_ivf._balance_assign(gp, cent, a, jax_ivf_capacity)
    mine = ivf._balance_assign(_t(gp), _t(cent), _t(a, torch.int64), cap)
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert np.bincount(ref, minlength=C).max() <= cap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spill_placement_is_the_row_at_a_time_greedy(seed):
    # the reference places spilled rows one at a time; the port takes
    # vectorized runs and must land every row in the same cluster
    rng = np.random.RandomState(seed)
    n_c, cap, n = 12, 9, 50
    counts = rng.randint(0, cap // 2, n_c)
    counts[:3] = cap                        # some clusters start full
    assert n <= n_c * cap - counts.sum()    # room for every row
    pref = np.stack([rng.permutation(n_c) for _ in range(n)])
    ref_counts, ref = counts.copy(), []
    for row in pref:
        c = next(c for c in row if ref_counts[c] < cap)
        ref_counts[c] += 1
        ref.append(c)
    got = ivf._place_in_order(pref, counts, cap)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(counts, ref_counts)


def _reference_layout(assign, n_clusters, cap):
    """The reference's cluster-major slots (repro/serve/ivf.py build)."""
    counts = np.bincount(assign, minlength=n_clusters)
    order = np.argsort(assign, kind="stable")
    offsets = np.cumsum(counts) - counts
    within = np.arange(len(assign)) - offsets[assign[order]]
    return order, assign[order] * cap + within


def test_layout_matches_reference():
    gp, cent, a = _skewed(1)
    cap = ivf.capacity(400, C, 1.25)
    bal = jax_ivf._balance_assign(gp, cent, a, cap)
    order_r, slots_r = _reference_layout(bal, C, cap)
    order, slots = ivf.segment_layout(_t(bal, torch.int64), C, cap)
    np.testing.assert_array_equal(order.numpy(), order_r)
    np.testing.assert_array_equal(slots.numpy(), slots_r)


def test_build_matches_reference_from_the_same_start(data, projected,
                                                     monkeypatch):
    L, G, _ = data
    gp, gn = projected
    jidx = JaxIVFIndex.build_projected(jnp.asarray(L), jnp.asarray(gp),
                                       jnp.asarray(gn), n_clusters=C,
                                       nprobe=3, iters=6, seed=4)
    monkeypatch.setattr(ivf, "kmeans_projected", functools.partial(
        ivf.kmeans_projected, start=_jax_start(4, M)))
    idx = IVFIndex.build_projected(L, gp, gn, n_clusters=C, nprobe=3,
                                   iters=6, seed=4, device=CPU)
    assert idx.cap == jidx.cap
    np.testing.assert_array_equal(idx.ids_pad.numpy(),
                                  np.asarray(jidx.ids_pad))
    np.testing.assert_array_equal(idx.gp_pad.numpy(), np.asarray(jidx.gp_pad))
    np.testing.assert_array_equal(idx.gn_pad.numpy(), np.asarray(jidx.gn_pad))


# -- product quantizer --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pq(projected):
    gp, _ = projected
    return JaxProductQuantizer.train(gp - gp.mean(0), n_subspaces=5, bits=4,
                                     iters=4, seed=0)


def test_pq_carried_across_matches_reference(jax_pq, projected):
    gp, _ = projected
    vecs = gp - gp.mean(0)
    pq = pq_from_jax(np.asarray(jax_pq.codebooks), jax_pq.dim, device=CPU)
    assert (pq.n_subspaces, pq.n_codes, pq.sub_dim, pq.bits, pq.code_bytes) \
        == (5, 16, 3, 4, 5)
    codes_j = np.asarray(jax_pq.encode(jnp.asarray(vecs)))
    codes = pq.encode(_t(vecs), block_rows=100)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    np.testing.assert_array_equal(pq.decode(codes).numpy(),
                                  np.asarray(jax_pq.decode(codes_j)))
    q = vecs[:7]
    for name in ("ip_tables", "sqdist_tables"):
        tab = getattr(pq, name)(_t(q))
        tab_j = getattr(jax_pq, name)(jnp.asarray(q))
        np.testing.assert_allclose(tab.numpy(), np.asarray(tab_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            pq.adc(tab, codes).numpy(),
            np.asarray(jax_pq.adc(tab_j, codes_j)), rtol=1e-5, atol=1e-4)
    # ADC over sqdist tables is the distance to the decoded row
    dec = pq.decode(codes)
    direct = torch.cdist(_t(q), dec) ** 2
    torch.testing.assert_close(pq.adc(pq.sqdist_tables(_t(q)), codes),
                               direct, rtol=1e-4, atol=1e-3)


def test_pq_train_validation():
    x = np.random.RandomState(0).randn(20, 6).astype(np.float32)
    for kw in ({"bits": 0}, {"bits": 9}, {"n_subspaces": 7}):
        with pytest.raises(ValueError):
            ProductQuantizer.train(x, device=CPU, **kw)
    small = ProductQuantizer.train(x[:5], n_subspaces=3, bits=3, iters=2,
                                   device=CPU)
    assert small.codebooks.shape == (3, 8, 2)     # padded by repetition
    assert torch.isfinite(small.codebooks).all()


# -- the indexes over the reference's arrays ----------------------------------

@pytest.fixture(scope="module")
def jax_ivf_index(data):
    L, G, _ = data
    return JaxIVFIndex.build(jnp.asarray(L), jnp.asarray(G), n_clusters=C,
                             nprobe=3, iters=6, seed=0)


def _port_ivf(jidx, **kw):
    return ivf_index_from_jax(
        np.asarray(jidx.L), np.asarray(jidx.centroids),
        np.asarray(jidx.gp_pad), np.asarray(jidx.gn_pad),
        np.asarray(jidx.ids_pad), jidx.cap, jidx.n_clusters, jidx.nprobe,
        jidx.n_rows, device=CPU, **kw)


@pytest.mark.parametrize("nprobe", [1, 3, C])
def test_ivf_topk_matches_reference(jax_ivf_index, data, nprobe):
    _, _, q = data
    idx = _port_ivf(jax_ivf_index)
    assert isinstance(idx, MetricIndex) and idx.size == M
    d_j, i_j = jax_ivf_index.topk(jnp.asarray(q), 7, nprobe=nprobe)
    d, i = idx.topk(torch.from_numpy(q), 7, nprobe=nprobe)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-4)


@pytest.fixture(scope="module")
def jax_ivfpq_index(data):
    L, G, _ = data
    return JaxIVFPQIndex.build(jnp.asarray(L), jnp.asarray(G), n_clusters=C,
                               nprobe=3, n_subspaces=4, bits=5,
                               rerank_depth=30, iters=5, seed=0)


def _port_ivfpq(jidx, store):
    return ivfpq_index_from_jax(
        np.asarray(jidx.L), np.asarray(jidx.centroids),
        np.asarray(jidx.pq.codebooks), jidx.pq.dim,
        np.asarray(jidx.codes_pad), np.asarray(jidx.t_pad),
        np.asarray(jidx.ids_pad), jidx.gp_full, jidx.gn_full, jidx.cap,
        jidx.n_clusters, jidx.nprobe, jidx.n_rows,
        rerank_depth=jidx.rerank_depth, store=store, device=CPU)


@pytest.mark.parametrize("store", ["device", "host"])
@pytest.mark.parametrize("nprobe,rerank", [(3, 0), (3, 30), (C, 0), (C, 50)])
def test_ivfpq_topk_matches_reference(jax_ivfpq_index, data, store, nprobe,
                                      rerank):
    _, _, q = data
    idx = _port_ivfpq(jax_ivfpq_index, store)
    d_j, i_j = jax_ivfpq_index.topk(jnp.asarray(q), 6, nprobe=nprobe,
                                    rerank=rerank)
    d, i = idx.topk(torch.from_numpy(q), 6, nprobe=nprobe, rerank=rerank)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-4)


def test_ivfpq_accounting_matches_reference(jax_ivfpq_index, data):
    _, _, q = data
    idx = _port_ivfpq(jax_ivfpq_index, "host")
    assert idx.code_bytes_per_row == jax_ivfpq_index.code_bytes_per_row
    assert idx.compression_ratio == pytest.approx(
        jax_ivfpq_index.compression_ratio)
    p, dc = idx.probe_stats(q, nprobe=4)
    p_j, dc_j = jax_ivfpq_index.probe_stats(jnp.asarray(q), nprobe=4)
    np.testing.assert_array_equal(p, p_j)
    # the factored distance rounds with its operands (|qp|^2 + |c|^2 ~ 200)
    np.testing.assert_allclose(dc, dc_j, rtol=1e-5, atol=1e-3)
    mem = index_memory(idx)
    assert mem["host_store"] == M * K * 4 + M * 4
    assert mem["codes"] >= idx.codes_pad.numel()


# -- the port's own builds ----------------------------------------------------

@pytest.fixture(scope="module")
def own(data):
    L, G, q = data
    exact = ExactIndex.build(L, G, device=CPU)
    ivf_idx = IVFIndex.build(L, G, n_clusters=C, nprobe=2, iters=6,
                             device=CPU)
    pq_idx = IVFPQIndex.build(L, G, n_clusters=C, nprobe=2, n_subspaces=4,
                              bits=4, rerank_depth=20, iters=4, device=CPU)
    return exact, ivf_idx, pq_idx, torch.from_numpy(q)


def test_own_ivf_full_probe_equals_exact(own):
    exact, idx, _, q = own
    d_e, i_e = exact.topk(q, 10)
    d, i = idx.topk(q, 10, nprobe=C)
    np.testing.assert_array_equal(i.numpy(), i_e.numpy())
    torch.testing.assert_close(d, d_e, rtol=1e-5, atol=1e-4)
    assert recall_at_k(idx.topk(q, 10)[1], i_e) > 0.5


def test_own_ivf_cap_is_bounded(own):
    _, idx, _, _ = own
    assert idx.cap == ivf.capacity(M, C, 1.25) and idx.cap % 8 == 0
    fills = (idx.ids_pad.view(C, idx.cap) >= 0).sum(1)
    assert int(fills.max()) <= idx.cap and int(fills.sum()) == M
    ids = idx.ids_pad[idx.ids_pad >= 0]
    assert torch.equal(torch.sort(ids).values, torch.arange(M,
                                                            dtype=torch.int32))
    pads = idx.ids_pad < 0
    assert bool((idx.gn_pad[pads] == BIG).all())
    assert bool((idx.gp_pad[pads] == 0).all())


def test_own_ivfpq_full_probe_full_rerank_equals_exact(own):
    exact, _, idx, q = own
    d_e, i_e = exact.topk(q, 10)
    d, i = idx.topk(q, 10, nprobe=C, rerank=M)
    np.testing.assert_array_equal(i.numpy(), i_e.numpy())
    torch.testing.assert_close(d, d_e, rtol=1e-5, atol=1e-4)
    raw = recall_at_k(idx.topk(q, 10, nprobe=C, rerank=0)[1], i_e)
    reranked = recall_at_k(idx.topk(q, 10, nprobe=C, rerank=40)[1], i_e)
    assert reranked >= raw
    assert idx.compression_ratio == pytest.approx((4 * K + 4) / (4 + 4))


def test_under_filled_probe_surfaces_minus_one():
    L, G, q = _clustered(m=40, n_blobs=2, seed=5)
    idx = IVFIndex.build(L, G, n_clusters=4, nprobe=1, cap_factor=2.0,
                         iters=3, device=CPU)
    d, i = idx.topk(torch.from_numpy(q), idx.cap, nprobe=1)
    assert bool((i == -1).any()) and bool((d[i == -1] >= BIG).all())


# -- knobs, refusals, engine, CLI ---------------------------------------------

def test_scan_impl_knob_on_a_cpu_index(own, data):
    _, idx, pq_idx, q = own
    assert scan.SCAN_IMPLS == ("auto", "xla", "pallas")
    assert scan.resolve_scan_impl("auto", device=CPU) == "xla"
    assert scan.resolve_scan_impl("auto", "xla", CPU) == "xla"
    a = idx.topk(q, 5, scan_impl="auto")
    b = idx.topk(q, 5, scan_impl="xla")
    assert torch.equal(a[1], b[1])
    for index in (idx, pq_idx):
        with pytest.raises(ValueError, match="CUDA index"):
            index.topk(q, 5, scan_impl="pallas")
        with pytest.raises(ValueError, match="unknown scan_impl"):
            index.topk(q, 5, scan_impl="triton")
    L, G, _ = data
    with pytest.raises(ValueError, match="CUDA index"):
        IVFIndex.build(L, G, n_clusters=C, scan_impl="pallas", device=CPU)


def test_refusals(own, data):
    _, idx, pq_idx, q = own
    L, G, _ = data
    for index in (idx, pq_idx):
        with pytest.raises(ValueError, match="nprobe must be >= 1"):
            index.topk(q, 5, nprobe=0)
        with pytest.raises(ValueError, match="gallery size"):
            index.topk(q, M + 1)
        with pytest.raises(ValueError, match="raise nprobe"):
            index.topk(q, index.cap + 1, nprobe=1, **(
                {"rerank": 0} if index is pq_idx else {}))
    with pytest.raises(NotImplementedError):
        IVFIndex.build(L, G, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError):
        IVFPQIndex.build(L, G, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="store"):
        IVFPQIndex.build(L, G, store="disk", device=CPU)


@pytest.mark.parametrize("which", [1, 2])
def test_engine_over_ann_index(own, which):
    index, q = own[which], own[3]
    eng = RetrievalEngine(index, k_top=5, buckets=(8, 32))
    eng.warmup()
    dists, ids = eng.search(q[:20])
    d, i = index.topk(q[:20], 5)
    np.testing.assert_array_equal(ids, i.numpy())
    np.testing.assert_allclose(dists, d.numpy(), rtol=1e-6, atol=1e-6)
    st = eng.stats()
    assert st["index"] == type(index).__name__ and st["backend"] == "cpu"


def test_build_timings(data):
    L, G, _ = data
    t = {}
    IVFPQIndex.build_projected(L, G @ L.T, np.sum((G @ L.T) ** 2, 1),
                               n_clusters=4, n_subspaces=2, bits=2, iters=2,
                               device=CPU, timings=t)
    assert set(t) == {"kmeans", "balance_layout", "pq_train", "encode"}
    t = {}
    IVFIndex.build_projected(L, G @ L.T, np.sum((G @ L.T) ** 2, 1),
                             n_clusters=4, iters=2, device=CPU, timings=t)
    assert set(t) == {"kmeans", "balance_layout"}


@pytest.mark.parametrize("index", ["ivf", "ivfpq"])
def test_cli_serves_ann_on_cpu(index, capsys):
    serve_retrieval.main(["--device", "cpu", "--index", index,
                          "--gallery-size", "800", "--train-steps", "0",
                          "--requests", "40", "--n-clusters", "8",
                          "--nprobe", "3", "--n-subspaces", "4",
                          "--pq-store", "host"])
    out = capsys.readouterr().out
    name = {"ivf": "IVFIndex", "ivfpq": "IVFPQIndex"}[index]
    assert f"index[{name}]" in out and "resolves to xla" in out
    assert "requests=40" in out and "purity@10" in out
    if index == "ivfpq":
        assert "store=host" in out
