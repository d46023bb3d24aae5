"""The port's metric_topk (repro_torch) held against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's ``metric_topk`` runs the kernel's plain version; the
reference runs its Pallas kernel in interpret mode (as
tests/test_metric_topk.py does) and its XLA path. Ids must be exact and
distances within rtol/atol 1e-5 (f32 on both sides, different summation
order). The CUDA kernel itself is checked against its plain version in
tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import _dispatch as jax_dispatch
from repro.kernels.metric_topk import metric_topk as jax_metric_topk
from repro.kernels.metric_topk import metric_topk_naive as jax_naive
from repro.kernels.metric_topk import metric_topk_xla as jax_metric_topk_xla
from repro.kernels.metric_topk import project_gallery as jax_project_gallery

from repro_torch.kernels import _dispatch
from repro_torch.kernels.metric_topk import (metric_topk, metric_topk_fused,
                                             metric_topk_naive,
                                             metric_topk_plain,
                                             project_gallery)
from repro_torch.kernels.metric_topk.kernel import (BLOCK_K, BLOCK_M,
                                                    LIST_K, MAX_STAGES,
                                                    QUERY_TILES, SMEM_LIMIT,
                                                    launch_plan, proj_smem,
                                                    scan_smem)

RTOL = ATOL = 1e-5


SHAPES = [
    (64, 1024, 128, 64, 10),     # even tiles
    (16, 300, 40, 12, 5),        # nothing divides the tile sizes
    (7, 129, 33, 9, 3),          # tiny + odd everything
    (200, 2048, 96, 48, 20),     # queries over several tiles
    (128, 512, 128, 128, 1),     # k_top = 1
    (8, 96, 24, 8, 96),          # k_top = M (full sort)
]


def _data(Nq, M, d, k, seed=0):
    rng = np.random.RandomState(seed)
    L = (0.3 * rng.randn(k, d)).astype(np.float32)
    q = rng.randn(Nq, d).astype(np.float32)
    G = rng.randn(M, d).astype(np.float32)
    return L, q, G


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _both(Nq, M, d, k, seed):
    """Projected gallery from the reference, shared by both packages."""
    L, q, G = _data(Nq, M, d, k, seed)
    gp, gn = jax_project_gallery(jnp.asarray(L), jnp.asarray(G))
    return L, q, np.asarray(gp), np.asarray(gn)


@pytest.mark.parametrize("Nq,M,d,k,K", SHAPES)
def test_matches_jax_pallas_kernel(Nq, M, d, k, K):
    L, q, gp, gn = _both(Nq, M, d, k, seed=Nq + M)
    d_ref, i_ref = jax_metric_topk(jnp.asarray(L), jnp.asarray(q),
                                   jnp.asarray(gp), jnp.asarray(gn),
                                   k_top=K, use_kernel=True)
    d_pt, i_pt = metric_topk(_t(L), _t(q), _t(gp), _t(gn), k_top=K)
    assert d_pt.dtype == torch.float32 and i_pt.dtype == torch.int32
    np.testing.assert_array_equal(i_pt.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d_pt.numpy(), np.asarray(d_ref),
                               rtol=RTOL, atol=ATOL)
    assert (np.diff(d_pt.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("Nq,M,d,k,K", SHAPES)
def test_matches_jax_xla_path(Nq, M, d, k, K):
    L, q, gp, gn = _both(Nq, M, d, k, seed=Nq + M + 1)
    d_ref, i_ref = jax_metric_topk_xla(jnp.asarray(L), jnp.asarray(q),
                                       jnp.asarray(gp), jnp.asarray(gn), K)
    d_pt, i_pt = metric_topk_plain(_t(L), _t(q), _t(gp), _t(gn), K)
    np.testing.assert_array_equal(i_pt.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d_pt.numpy(), np.asarray(d_ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Nq,M,d,k,K", [(9, 2048, 40, 24, 257),
                                         (5, 2048, 40, 24, 1024),
                                         (3, 1100, 20, 12, 1100)])
def test_wide_k_top_matches_jax_xla_path(Nq, M, d, k, K):
    """k_top past the kernel's 256-entry shared lists (its wide path on
    the card), up to k_top = M: the plain path against the reference.
    With a thousand neighbours a query, ranks whose distances lie within
    f32 rounding of each other occur, so the rule is chip_smoke's:
    distances within atol + rtol * (qn + gn), ids equal wherever the
    reference's distance is apart from its neighbours' by more than that,
    and at a near-tie the port's id carries its rank's distance."""
    L, q, gp, gn = _both(Nq, M, d, k, seed=Nq + K)
    d_ref, i_ref = (np.asarray(a) for a in jax_metric_topk_xla(
        jnp.asarray(L), jnp.asarray(q), jnp.asarray(gp), jnp.asarray(gn), K))
    d_pt, i_pt = (a.numpy() for a in metric_topk(_t(L), _t(q), _t(gp),
                                                 _t(gn), k_top=K))
    qp = q.astype(np.float64) @ L.T.astype(np.float64)
    qn = np.sum(qp ** 2, 1)
    D = qn[:, None] + gn[None, :] - 2.0 * qp @ gp.T.astype(np.float64)
    tol = ATOL + RTOL * (qn[:, None] + gn[i_ref])
    assert np.all(np.abs(d_pt - d_ref) <= tol)
    nxt = np.sort(D, axis=1)[:, K:K + 1] if K < M else \
        np.full((Nq, 1), np.inf)
    lo = np.concatenate([np.full((Nq, 1), -np.inf), d_ref[:, :-1]], 1)
    hi = np.concatenate([d_ref[:, 1:], nxt], 1)
    apart = ((d_ref - lo) > tol) & ((hi - d_ref) > tol)
    assert np.all((i_pt == i_ref)[apart]) and apart.mean() > 0.9
    assert np.all(np.abs(np.take_along_axis(D, i_pt, 1) - d_ref) <= tol)
    assert len(set(i_pt[0])) == K
    assert (np.diff(d_pt, axis=1) >= 0).all()


@pytest.mark.parametrize("shape", [(300, 40, 12), (129, 33, 33)])
def test_project_gallery_matches_jax(shape):
    M, d, k = shape
    L, _, G = _data(1, M, d, k, seed=M)
    gp_ref, gn_ref = jax_project_gallery(jnp.asarray(L), jnp.asarray(G))
    gp, gn = project_gallery(_t(L), _t(G))
    assert gp.shape == (M, k) and gn.shape == (M,)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gp_ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gn.numpy(), np.asarray(gn_ref),
                               rtol=RTOL, atol=ATOL)


def test_gn_defaults_to_row_norms():
    L, q, gp, gn = _both(12, 200, 32, 16, seed=3)
    with_gn = metric_topk(_t(L), _t(q), _t(gp), _t(gn), k_top=6)
    without = metric_topk(_t(L), _t(q), _t(gp), k_top=6)
    np.testing.assert_array_equal(with_gn[1].numpy(), without[1].numpy())


def test_matches_naive_per_pair_baseline():
    L, q, G = _data(12, 200, 32, 16)
    gp, gn = project_gallery(_t(L), _t(G))
    _, i_pt = metric_topk(_t(L), _t(q), gp, gn, k_top=8)
    _, i_nv = metric_topk_naive(_t(L), _t(q), _t(G), 8, chunk=5)
    _, i_jx = jax_naive(jnp.asarray(L), jnp.asarray(q), jnp.asarray(G), 8,
                        chunk=5)
    np.testing.assert_array_equal(i_pt.numpy(), i_nv.numpy())
    np.testing.assert_array_equal(i_nv.numpy(), np.asarray(i_jx))


def test_bf16_inputs_are_cast_to_f32():
    L, q, gp, gn = _both(16, 256, 64, 32, seed=5)
    d32, i32 = metric_topk(_t(L), _t(q), _t(gp), _t(gn), k_top=5)
    d16, i16 = metric_topk(_t(L).bfloat16(), _t(q).bfloat16(), _t(gp),
                           _t(gn), k_top=5)
    assert d16.dtype == torch.float32
    overlap = np.mean([len(set(i16[i].tolist()) & set(i32[i].tolist())) / 5
                       for i in range(16)])
    assert overlap > 0.8


def test_k_top_larger_than_gallery_raises():
    L, q, gp, gn = _both(4, 16, 8, 4, seed=0)
    with pytest.raises(ValueError, match="k_top=17 > gallery size M=16"):
        metric_topk(_t(L), _t(q), _t(gp), _t(gn), k_top=17)
    with pytest.raises(ValueError):
        jax_metric_topk(jnp.asarray(L), jnp.asarray(q), jnp.asarray(gp),
                        jnp.asarray(gn), k_top=17)


@pytest.mark.parametrize("L_shape,d_in", [
    ((8,), None),            # 1-D
    ((0, 8), None),          # empty d_out
    ((4, 6), 8),             # wrong d_in
    ((8, 8), 6),             # square: transposed-factor hint
    ((6, 8), 6),             # transposed rectangular factor (no hint)
])
def test_check_metric_factor_messages_match_reference(L_shape, d_in):
    def message(check, L):
        with pytest.raises(ValueError) as e:
            check(L, d_in, what="L")
        return str(e.value)

    ours = message(_dispatch.check_metric_factor, torch.zeros(L_shape))
    ref = message(jax_dispatch.check_metric_factor, jnp.zeros(L_shape))
    assert ours == ref


def test_topk_by_distance_matches_reference_on_ties():
    rng = np.random.RandomState(0)
    d = rng.randint(0, 5, size=(6, 40)).astype(np.float32)   # many ties
    ids = np.stack([rng.permutation(40) for _ in range(6)]).astype(np.int32)
    cd, ci = _dispatch.topk_by_distance(torch.from_numpy(d),
                                        torch.from_numpy(ids), 9)
    rd, ri = jax_dispatch.topk_by_distance(jnp.asarray(d), jnp.asarray(ids),
                                           9)
    np.testing.assert_array_equal(cd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ci.numpy(), np.asarray(ri))


def test_duplicated_rows_tie_to_smaller_index():
    L, q, G = _data(10, 50, 16, 8, seed=2)
    G3 = np.concatenate([G, G, G])          # row r ties with r+50, r+100
    gp, gn = jax_project_gallery(jnp.asarray(L), jnp.asarray(G3))
    _, i_ref = jax_metric_topk_xla(jnp.asarray(L), jnp.asarray(q), gp, gn, 9)
    _, i_pt = metric_topk(_t(L), _t(q), _t(gp), _t(gn), k_top=9)
    np.testing.assert_array_equal(i_pt.numpy(), np.asarray(i_ref))


def test_fused_wrapper_refuses_cpu_tensors():
    L, q, gp, gn = _both(4, 32, 8, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        metric_topk_fused(_t(q), _t(L), _t(gp), _t(gn), k_top=3)


@pytest.mark.parametrize("nq,d_in,d_out,m", [
    (1, 21504, 1000, 1_000_000), (64, 21504, 1000, 1_000_000),
    (512, 96, 48, 2048), (7, 36, 12, 129), (65, 21504, 1000, 1_000_000),
    (200, 300, 36, 4000), (300, 8, 4, 1), (9, 1024, 1000, 128)])
def test_split_plan_covers_every_row_and_column(nq, d_in, d_out, m):
    """The launch plan: query tiles covering the batch, the projection's
    d_in slices (whole 32-column stages) covering d_in once, the scan's
    gallery splits (whole 128-row tiles) covering M once, each aiming at
    one block an SM."""
    for k_top in (1, 10, LIST_K):
        plan = launch_plan(nq, d_in, d_out, m, k_top, n_sm=132)
        assert plan.n_tile in QUERY_TILES
        assert (plan.qtiles - 1) * plan.n_tile < nq <= \
            plan.qtiles * plan.n_tile
        assert plan.kchunk % BLOCK_K == 0
        assert (plan.ksplit - 1) * plan.kchunk < d_in <= \
            plan.ksplit * plan.kchunk
        assert plan.rows_per_split % BLOCK_M == 0
        assert (plan.nsplit - 1) * plan.rows_per_split < m <= \
            plan.nsplit * plan.rows_per_split
        assert plan.qtiles * plan.nsplit <= max(133, plan.qtiles)
        assert 2 <= plan.stages <= MAX_STAGES


def test_query_tiles_for_every_batch_size():
    """Nq 1..300: the smallest tile that holds the batch (8 for Nq 1 and
    7, 16 for 9, 64 for 64, 128 for 65 and up), halved only where a
    256-entry list would not fit, and every block within 227 KB."""
    for nq in range(1, 301):
        plan = launch_plan(nq, 21504, 1000, 1_000_000, 10, n_sm=132)
        want = next((t for t in QUERY_TILES if nq <= t), QUERY_TILES[-1])
        assert plan.n_tile == want and plan.qtiles == -(-nq // want), nq
        assert scan_smem(want, 10, plan.stages) <= SMEM_LIMIT
        assert proj_smem(want) <= SMEM_LIMIT
        big = launch_plan(nq, 21504, 1000, 1_000_000, LIST_K, n_sm=132)
        assert big.n_tile <= want, nq
        assert scan_smem(big.n_tile, LIST_K, big.stages) <= SMEM_LIMIT


@pytest.mark.parametrize("nq", [1, 9, 64, 200])
@pytest.mark.parametrize("k_top", [LIST_K + 1, 1024, 5000, 1_000_000])
def test_wide_plan_keeps_the_query_tile(nq, k_top):
    """Past LIST_K the scan keeps no lists (the wide path writes every
    distance out), so its blocks plan as a scan without lists: the query
    tile that holds the batch, as at k_top 10, and a ring within 227 KB;
    the gallery is still read once per query tile."""
    wide = launch_plan(nq, 21504, 1000, 1_000_000, k_top, n_sm=132)
    assert wide == launch_plan(nq, 21504, 1000, 1_000_000, 0, n_sm=132)
    assert wide.n_tile == launch_plan(nq, 21504, 1000, 1_000_000, 10,
                                      n_sm=132).n_tile
    assert scan_smem(wide.n_tile, k_top, wide.stages) == \
        scan_smem(wide.n_tile, 0, wide.stages) <= SMEM_LIMIT


@pytest.mark.parametrize("n", QUERY_TILES)
@pytest.mark.parametrize("k_top", [1, 10, 64, 256])
def test_shared_memory_budget(n, k_top):
    """The scan's ring takes as many stages (2..8) as fit beside its
    lists; a tile whose 2-stage block would not fit is never chosen."""
    stages = [s for s in range(2, MAX_STAGES + 1)
              if scan_smem(n, k_top, s) <= SMEM_LIMIT]
    plan = launch_plan(n, 1024, 1000, 100_000, k_top, n_sm=132)
    assert scan_smem(plan.n_tile, k_top, plan.stages) <= SMEM_LIMIT
    if stages:
        assert plan.n_tile == n and plan.stages == max(stages)
    else:
        assert plan.n_tile < n
    assert proj_smem(n) <= SMEM_LIMIT
    # ring + lo buffers + cross tile + lists grow with every term
    assert scan_smem(n, k_top, 3) - scan_smem(n, k_top, 2) == \
        BLOCK_M * BLOCK_K * 4 + 2 * n * BLOCK_K * 4 + 16


@pytest.mark.parametrize("d_in,d_out", [(9, 33), (33, 9), (36, 1000)])
def test_wrapper_pads_rows_to_the_tma_stride(d_in, d_out):
    """q, L and gp with rows not a multiple of 4 floats get zero columns;
    the padded operands give the same neighbours and distances."""
    L, q, gp, gn = _both(5, 200, d_in, d_out, seed=d_in + d_out)
    Lp, qp_, gpp = (_dispatch.tma_operand(_t(a)) for a in (L, q, gp))
    assert Lp.shape == (d_out, -(-d_in // 4) * 4)
    assert gpp.shape == (200, -(-d_out // 4) * 4)
    assert bool((gpp[:, d_out:] == 0).all())
    # zero columns of q and L leave qp unchanged; zero columns of gp meet
    # the zero columns qp gets (its rows as long as gp's)
    qp_pad = _dispatch.tma_operand(qp_ @ Lp.T)
    d_pad, i_pad = _dispatch.topk_by_distance(
        torch.clamp_min(torch.sum(qp_pad ** 2, 1)[:, None] + _t(gn)[None]
                        - 2 * qp_pad @ gpp.T, 0.0),
        torch.arange(200, dtype=torch.int32).expand(5, 200), 7)
    d_ref, i_ref = metric_topk(_t(L), _t(q), _t(gp), _t(gn), k_top=7)
    np.testing.assert_array_equal(i_pad.numpy(), i_ref.numpy())
    np.testing.assert_allclose(d_pad.numpy(), d_ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    plan = launch_plan(5, Lp.shape[1], d_out, 200, 7, n_sm=132)
    assert plan.ksplit * plan.kchunk >= Lp.shape[1]


@pytest.mark.parametrize("n,block,mult", [(5, 128, 8), (300, 128, 8),
                                          (129, 512, 128), (128, 128, 8)])
def test_tiling_helpers_match_reference(n, block, mult):
    assert _dispatch.round_up(n, mult) == jax_dispatch.round_up(n, mult)
    assert _dispatch.pick_block(n, block, mult) == \
        jax_dispatch.pick_block(n, block, mult)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    target = _dispatch.round_up(n, mult)
    ours = _dispatch.pad_axis(torch.from_numpy(x), target, 0, value=1e30)
    ref = jax_dispatch.pad_axis(jnp.asarray(x), target, 0, value=1e30)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_scan_helpers_match_reference():
    from repro.serve import scan as jax_scan
    from repro_torch.serve import scan
    rng = np.random.RandomState(1)
    d = rng.randint(0, 6, size=(5, 30)).astype(np.float32)
    ids = np.tile(np.arange(30, dtype=np.int32), (5, 1))
    ld, li = scan.local_topk(torch.from_numpy(d), torch.from_numpy(ids), 7)
    rd, ri = jax_scan.local_topk(jnp.asarray(d), jnp.asarray(ids), 7)
    np.testing.assert_array_equal(ld.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(li.numpy(), np.asarray(ri))
    approx = rng.randint(-1, 30, size=(5, 7))
    assert scan.recall_at_k(approx, li.numpy()) == \
        jax_scan.recall_at_k(approx, np.asarray(ri))
    L, q, _ = _data(6, 1, 20, 8, seed=2)
    np.testing.assert_allclose(
        scan.project_queries(_t(L), _t(q)).numpy(),
        np.asarray(jax_scan.project_queries(jnp.asarray(L), jnp.asarray(q))),
        rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="transposed factor"):
        scan.project_queries(_t(L)[:6, :8], _t(q)[:, :6])
