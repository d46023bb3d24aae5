"""The port's CUDA kernels against their plain versions, on the card:
metric_topk, dml_pair (forward and gradients), pairwise_sqdist, ivf_scan
and pq_adc (bit for bit), the IVF / IVFPQ indexes on the card,
flash_attention and ssd_scan (bf16 and f32), a reduced zamba2 backbone
through both, a reduced gemma-7b at head dim 256, hubert-xlarge
(non-causal) and pixtral-12b at full width cut to 2 layers on frame /
patch embeddings and tokens, rwkv6 at full width
(the chunked form's gradients at the decay clamp, decode against
``apply`` at 2 layers; plain torch, no kernel), the mutable
gallery (card against the CPU port, and its snapshot round trip) and
the closed loop (mined pairs on the card equal to the CPU's, the
stream's gather on the card equal to the host's, a small loop's
launches), granite-moe's MoE layer at full width (grouped against the
dense oracle, forward and backward bit-stable, remat's recomputation
routing as the forward did at bf16). Top-k
widths past the 256-entry shared lists (the wide path), pq_adc tables
taken in chunks (S 200, 1000) and pairwise_sqdist past 65535 tiles of yp
rows are among the shapes; so are ivf_scan's plan (made on the card, against
``work_plan``) and both segment scans on skewed and repeated probes.

Marked ``cuda``: without a card every test here skips (a CUDA kernel has
no CPU mode). Run on a machine with one card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports torch and the port only (no jax), so it also runs where
the JAX reference is not installed. Comparison rule, f32 on both sides
with a different summation order: distances within atol + rtol *
(qn_i + gn_j), rtol = atol = 1e-5 (the rounding of qn + gn - 2 qp.gp
scales with its operands); ids equal at every rank whose plain distance
is apart from its neighbours' by more than that. pq_adc: ``torch.equal``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import losses
from repro_torch.kernels.dml_pair import (dml_pair_fused, dml_pair_loss_fused,
                                          dml_pair_loss_reference,
                                          dml_pair_ref)
from repro_torch.kernels.metric_topk import (metric_topk, metric_topk_fused,
                                             metric_topk_plain,
                                             project_gallery)
from repro_torch.kernels.metric_topk.kernel import LIST_K
from repro_torch.kernels._dispatch import BIG
from repro_torch.kernels.flash_attention.cases import PARITY as FA_PARITY
from repro_torch.kernels.ssd_chunk import cases as ssd_cases
from repro_torch.kernels.ssd_chunk.cases import PARITY as SSD_PARITY
from repro_torch.kernels.ssd_chunk.cases import PLANNED as SSD_PLANNED
from repro_torch.kernels.ssd_chunk.cases import TWO_PLANS as SSD_TWO_PLANS
from repro_torch.kernels.ssd_chunk.cases import BF16_ROUND, SSD_TOL
from repro_torch.kernels.ivf_scan import (ivf_scan_topk, ivf_scan_topk_fused,
                                          ivf_scan_topk_ref)
from repro_torch.kernels.ivf_scan.kernel import (device_plan, max_groups,
                                                 work_plan)
from repro_torch.kernels.pairwise_dist import (pairwise_sqdist,
                                               pairwise_sqdist_any,
                                               pairwise_sqdist_ref)
from repro_torch.kernels.pq_adc import (pq_adc_topk, pq_adc_topk_fused,
                                        pq_adc_topk_ref)
from repro_torch.serve import IVFIndex, IVFPQIndex, recall_at_k

from _flash_tile_plan import (EDGE_PLANS, OFFSET_PLANS, PARITY_PLANS,
                              check_plan_against_mask)

RTOL = ATOL = 1e-5
SHAPES = [(64, 1024, 128, 64, 10), (16, 300, 40, 12, 5), (7, 129, 33, 9, 3),
          (200, 2048, 96, 48, 20), (128, 512, 128, 128, 1),
          (8, 96, 24, 8, 96), (3, 5000, 200, 150, LIST_K),
          (40, 3000, 1000, 1000, 10), (3, 5000, 200, 150, LIST_K + 1),
          (70, 3000, 100, 64, 1024), (2, 700, 40, 24, 700)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _data(Nq, M, d, k, seed, device):
    rng = np.random.RandomState(seed)
    arrays = (0.3 * rng.randn(k, d), rng.randn(Nq, d), rng.randn(M, d))
    return (torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,M,d,k,K", SHAPES)
def test_kernel_matches_plain_version(cuda_device, Nq, M, d, k, K):
    L, q, G = _data(Nq, M, d, k, Nq + M, cuda_device)
    gp, gn = project_gallery(L, G)
    before = metric_topk_fused.launches
    dk, ik = metric_topk(L, q, gp, gn, k_top=K)
    dp, ip = metric_topk_plain(L, q, gp, gn, K)
    torch.cuda.synchronize()
    assert metric_topk_fused.launches == before + 1
    qn = torch.sum((q @ L.T) ** 2, dim=1)
    tol = ATOL + RTOL * (qn[:, None] + gn[ip.long()])
    assert bool(((dk - dp).abs() <= tol).all())
    # the (K+1)-th plain distance bounds the last rank's gap
    nxt = (metric_topk_plain(L, q, gp, gn, K + 1)[0][:, K:] if K < M
           else torch.full_like(dp[:, :1], float("inf")))
    inf = torch.full_like(dp[:, :1], float("inf"))
    apart = ((dp - torch.cat([-inf, dp[:, :-1]], 1)) > tol) & \
        ((torch.cat([dp[:, 1:], nxt], 1) - dp) > tol)
    assert bool((ik == ip)[apart].all())


# the query-tile sweep: Nq at and across the 8/16/64/128 tiles, k_top 1
# and 256, d_out 1000 (31.25 stages of 32) and 33 (padded to 36)
SWEEP = [(nq, k, kt) for nq in (1, 7, 9, 64, 65, 200)
         for k, kt in ((1000, 10), (1000, 256), (33, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,k,K", SWEEP)
def test_kernel_query_tile_sweep(cuda_device, Nq, k, K):
    test_kernel_matches_plain_version(cuda_device, Nq, 4000, 300, k, K)


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,d_out", [(9, 33), (33, 9), (21504, 1000)])
def test_kernel_repeat_calls_are_bit_equal(cuda_device, d_in, d_out):
    L, q, G = _data(65, 2000, d_in, d_out, 3, cuda_device)
    gp, gn = project_gallery(L, G)
    a = metric_topk_fused(q, L, gp, gn, k_top=17)
    b = metric_topk_fused(q, L, gp, gn, k_top=17)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 9, LIST_K, LIST_K + 1, 600])
def test_kernel_ties_go_to_the_smaller_id(cuda_device, K):
    L, q, G = _data(24, 200, 32, 16, 7, cuda_device)
    G = torch.cat([G, G, G])            # row r ties with r + 200, r + 400
    gp, gn = project_gallery(L, G)
    dk, ik = metric_topk(L, q, gp, gn, k_top=K)
    dp, ip = metric_topk_plain(L, q, gp, gn, K)
    torch.cuda.synchronize()
    tied = dk[:, 1:] == dk[:, :-1]
    if K > 1:
        assert int(tied.sum()) > 0
    assert bool((ik[:, 1:] > ik[:, :-1])[tied].all())
    qn = torch.sum((q @ L.T) ** 2, dim=1)
    tol = ATOL + RTOL * (qn[:, None] + gn[ip.long()])
    assert bool(((dk - dp).abs() <= tol).all())


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_do(cuda_device):
    L, q, G = _data(4, 300, 16, 8, 0, cuda_device)
    gp, gn = project_gallery(L, G)
    # past the widest shared list the wide path answers, up to k_top = M
    for K in (LIST_K + 1, 300):
        dk, ik = metric_topk(L, q, gp, gn, k_top=K)
        dp, ip = metric_topk_plain(L, q, gp, gn, K)
        torch.cuda.synchronize()
        assert torch.equal(torch.sort(ik, 1).values, torch.sort(ip, 1).values)
    with pytest.raises(ValueError, match="k_top=301"):
        metric_topk(L, q, gp, gn, k_top=301)
    with pytest.raises(ValueError, match="k_top=0"):
        metric_topk_fused(q, L, gp, gn, k_top=0)
    with pytest.raises(ValueError, match="contiguous"):
        metric_topk_fused(q.T.contiguous().T, L, gp, gn, k_top=3)
    with pytest.raises(ValueError, match="float32"):
        metric_topk_fused(q.double(), L, gp, gn, k_top=3)


# -- dml_pair ----------------------------------------------------------------

DML_SHAPES = [(8, 8, 8), (64, 32, 48), (256, 128, 512), (100, 60, 780),
              (512, 600, 780), (1000, 600, 780), (32, 100, 224),
              (37, 16, 24),
              (1000, 1000, 2048), (37, 16, 9), (130, 129, 33),
              (257, 1000, 4001)]


def _pairs(B, k, d, seed, device):
    rng = np.random.RandomState(seed)
    L = rng.randn(k, d) / np.sqrt(k * d)
    xs, ys = rng.randn(B, d), rng.randn(B, d)
    sim = (rng.rand(B) < 0.5).astype(np.int32)
    d2 = np.sort(np.sum(((xs - ys) @ L.T) ** 2, axis=1))
    i = B // 4 + int(np.argmax(np.diff(d2[B // 4:max(B // 4 + 2,
                                                      3 * B // 4)])))
    margin = float(0.5 * (d2[i] + d2[i + 1]))   # no d2 near the hinge
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(L, **f32), torch.tensor(xs, **f32),
            torch.tensor(ys, **f32), torch.tensor(sim, device=device), margin)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,d", DML_SHAPES)
def test_dml_pair_kernel_matches_plain_version(cuda_device, B, k, d):
    L, xs, ys, sim, margin = _pairs(B, k, d, B + k + d, cuda_device)
    before = dml_pair_fused.launches
    out = dml_pair_fused(L, xs, ys, sim, lam=1.3, margin=margin)
    ref = dml_pair_ref(L, xs, ys, sim, 1.3, margin)
    torch.cuda.synchronize()
    assert dml_pair_fused.launches == before + 1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
    # gradients: kernel forward + closed-form backward against autograd
    # through the plain version
    grads = []
    for fn in (dml_pair_loss_fused, dml_pair_loss_reference):
        args = [t.clone().requires_grad_(True) for t in (L, xs, ys)]
        fn(*args, sim, 1.3, margin).backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_dml_pair_kernel_at_training_width(cuda_device):
    """B 1000, k 1000, d 21504 (dml-imnet1m): forward against the plain
    version, and two calls bit-equal."""
    L, xs, ys, sim, margin = _pairs(1000, 1000, 21504, 1, cuda_device)
    out = dml_pair_fused(L, xs, ys, sim, lam=1.3, margin=margin)
    again = dml_pair_fused(L, xs, ys, sim, lam=1.3, margin=margin)
    ref = dml_pair_ref(L, xs, ys, sim, 1.3, margin)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
def test_dml_pair_kernel_is_deterministic_and_refuses_bf16(cuda_device):
    """Two calls are bit-equal; the kernel refuses bf16 tensors, and the
    loss with compute_dtype bf16 takes the reference's cast-and-product
    path instead of raising."""
    L, xs, ys, sim, margin = _pairs(300, 200, 4000, 0, cuda_device)
    a = dml_pair_fused(L, xs, ys, sim, margin=margin)
    b = dml_pair_fused(L, xs, ys, sim.float(), margin=margin)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="float32"):
        dml_pair_fused(L.bfloat16(), xs, ys, sim)
    batch = {"xs": xs, "ys": ys, "sim": sim}
    before = dml_pair_fused.launches
    loss, aux = losses.dml_pair_loss(L, batch, margin=margin,
                                     compute_dtype=torch.bfloat16)
    loss32, aux32 = losses.dml_pair_loss(L, batch, margin=margin)
    torch.cuda.synchronize()
    assert dml_pair_fused.launches == before + 1      # the f32 call only
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    # bf16 operands keep 8 mantissa bits: the loss within rtol 2e-2
    torch.testing.assert_close(loss, loss32, rtol=2e-2, atol=1e-5)
    for k in ("mean_sim_dist", "mean_dis_dist", "hinge_active_frac"):
        # both from an f32 d2: the plain product's, the kernel's
        torch.testing.assert_close(aux[k], aux32[k], rtol=2e-5, atol=1e-6)


# -- pairwise_sqdist ---------------------------------------------------------

# k not a multiple of 4 (the wrapper pads), the eval width, a long k, and
# M past the grid's y limit of 65535 tiles of 128 (narrow k)
PD_SHAPES = [(64, 128, 32), (37, 129, 9), (1, 7, 3), (256, 512, 520),
             (100, 300, 1000), (129, 517, 1003), (2000, 8000, 1000),
             (65, 200, 21504), (5, 8_400_000, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,k", PD_SHAPES)
def test_pairwise_kernel_matches_plain_version(cuda_device, N, M, k):
    rng = np.random.RandomState(N + M + k)
    xp = torch.tensor(rng.randn(N, k), dtype=torch.float32,
                      device=cuda_device)
    yp = torch.tensor(rng.randn(M, k), dtype=torch.float32,
                      device=cuda_device)
    before = pairwise_sqdist.launches
    D = pairwise_sqdist_any(xp, yp)
    D_ref = pairwise_sqdist_ref(xp, yp)
    torch.cuda.synchronize()
    assert pairwise_sqdist.launches == before + 1
    xn, yn = torch.sum(xp * xp, 1), torch.sum(yp * yp, 1)
    tol = ATOL + RTOL * (xn[:, None] + yn[None, :])
    assert bool(((D - D_ref).abs() <= tol).all())
    assert bool((D >= 0).all())


@pytest.mark.cuda
def test_pairwise_kernel_is_deterministic(cuda_device):
    """No split of k and no atomics: repeat calls are bit-equal."""
    rng = np.random.RandomState(0)
    xp, yp = (torch.tensor(rng.randn(n, 1000), dtype=torch.float32,
                           device=cuda_device) for n in (300, 2000))
    D = pairwise_sqdist(xp, yp)
    assert all(torch.equal(D, pairwise_sqdist(xp, yp)) for _ in range(3))


# -- ivf_scan / pq_adc ---------------------------------------------------------

def _segments(rng, C, cap, lo, hi, device):
    fills = rng.randint(lo, hi + 1, size=C)
    ids = np.full((C, cap), -1, np.int32)
    nid = 0
    for c in range(C):
        ids[c, :fills[c]] = np.arange(nid, nid + fills[c])
        nid += fills[c]
    return torch.tensor(ids, device=device)


def _probes(rng, Nq, C, nprobe, device, mode="distinct"):
    """Distinct clusters a row; "skewed": every row the same clusters;
    "repeat": ids repeated within a row."""
    if mode == "skewed":
        pr = np.tile(rng.choice(C, nprobe, replace=False), (Nq, 1))
    elif mode == "repeat":
        pr = rng.randint(0, C, (Nq, nprobe))
        pr[:, 1] = pr[:, 0]
        pr[:, 2::3] = pr[:, 2:3]
    else:
        pr = np.stack([rng.choice(C, nprobe, replace=False)
                       for _ in range(Nq)])
    return torch.tensor(pr, dtype=torch.int32, device=device)


def _ivf(seed, Nq, C, cap, k, nprobe, lo, hi, device, mode="distinct"):
    rng = np.random.RandomState(seed)
    ids = _segments(rng, C, cap, lo, hi, device)
    real = ids >= 0
    g = torch.tensor(rng.randn(C, cap, k), dtype=torch.float32,
                     device=device) * real[..., None]
    gn = torch.where(real, torch.sum(g * g, 2), torch.full_like(g[..., 0],
                                                                BIG))
    qp = torch.tensor(rng.randn(Nq, k), dtype=torch.float32, device=device)
    probes = _probes(rng, Nq, C, nprobe, device, mode)
    if mode == "repeat":                  # out of range: clipped
        probes[:, -1] = C + 3
        probes[0, 0] = -2
    return qp, probes, g, gn, ids


def _assert_ivf_close(args, kk, dk, ik):
    """The comparison rule of the module docstring."""
    qp, probes, g, gn, ids = args
    dp, ip = ivf_scan_topk_ref(*args, kk)
    gn_of = torch.full((int(ids.max()) + 2,), BIG, device=qp.device)
    gn_of[ids[ids >= 0].long()] = gn[ids >= 0]
    qn = torch.sum(qp * qp, 1)
    tol = ATOL + RTOL * (qn[:, None] + gn_of[ip.long()])
    assert bool(((dk - dp).abs() <= tol).all())
    inf = torch.full_like(dp[:, :1], float("inf"))
    nxt = (ivf_scan_topk_ref(*args, kk + 1)[0][:, kk:]
           if kk < probes.shape[1] * g.shape[1] else inf)
    apart = ((dp - torch.cat([-inf, dp[:, :-1]], 1)) > tol) & \
        ((torch.cat([dp[:, 1:], nxt], 1) - dp) > tol)
    assert bool((ik == ip)[apart].all())
    assert torch.equal(ik < 0, ip < 0)


IVF_SHAPES = [(5, 6, 32, 12, 3, 7, 32, 32), (4, 7, 16, 5, 2, 32, 0, 5),
              (9, 12, 45, 1000, 8, 1, 0, 45), (9, 12, 45, 1000, 8, 256, 0, 45),
              (3, 40, 70, 1003, 6, 100, 20, 70),
              (9, 12, 45, 1000, 8, 257, 0, 45),
              (3, 40, 70, 1003, 16, 1024, 20, 70),
              (64, 20, 1224, 1000, 16, 10, 1000, 1224),
              (1, 20, 1224, 1000, 16, 10, 1000, 1224)]


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,C,cap,k,nprobe,kk,lo,hi", IVF_SHAPES)
def test_ivf_scan_kernel_matches_plain_version(cuda_device, Nq, C, cap, k,
                                               nprobe, kk, lo, hi):
    args = _ivf(Nq + C + cap, Nq, C, cap, k, nprobe, lo, hi, cuda_device)
    before = ivf_scan_topk_fused.launches
    dk, ik = ivf_scan_topk(*args, kk=kk)
    torch.cuda.synchronize()
    assert ivf_scan_topk_fused.launches == before + 1
    _assert_ivf_close(args, kk, dk, ik)


# the cluster-major plan's edges: (probes, Nq, C, cap, k, nprobe, kk, lo,
# hi): every query on the same 16 clusters (one hot segment per group of
# 8 pairs; lists and the wide path), ids repeated in a row and out of
# range, 9,600 pairs (two plan launches), Nq 1 at the serving widths, and
# at kk 256 (624 lists of 256: merged in batches of 64)
IVF_PLAN_SHAPES = [("skewed", 64, 48, 300, 1000, 16, 10, 200, 300),
                   ("skewed", 64, 40, 70, 1003, 16, 300, 20, 70),
                   ("skewed", 3, 5, 40, 8, 5, 24, 20, 40),
                   ("repeat", 9, 12, 45, 1000, 8, 20, 0, 45),
                   ("repeat", 7, 10, 45, 64, 8, 300, 10, 45),
                   ("distinct", 600, 64, 40, 16, 16, 10, 10, 40),
                   ("distinct", 1, 48, 1224, 1000, 16, 10, 1000, 1224),
                   ("distinct", 1, 48, 1224, 64, 16, 256, 1000, 1224)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,Nq,C,cap,k,nprobe,kk,lo,hi", IVF_PLAN_SHAPES)
def test_ivf_scan_kernel_at_the_plans_edges(cuda_device, mode, Nq, C, cap, k,
                                            nprobe, kk, lo, hi):
    args = _ivf(Nq + cap, Nq, C, cap, k, nprobe, lo, hi, cuda_device, mode)
    dk, ik = ivf_scan_topk(*args, kk=kk)
    torch.cuda.synchronize()
    _assert_ivf_close(args, kk, dk, ik)
    if mode == "repeat":                  # a row scans one cluster twice
        assert bool((torch.sort(ik, 1).values[:, 1:] ==
                     torch.sort(ik, 1).values[:, :-1]).any())


@pytest.mark.cuda
def test_ivf_scan_takes_k_past_the_old_query_row_limit(cuda_device):
    """k 50,000: the old kernel kept the query row whole in shared memory
    (k up to ~49,600); the group's query slices now stream beside g's."""
    args = _ivf(5, 3, 4, 40, 50_000, 2, 20, 40, cuda_device)
    dk, ik = ivf_scan_topk(*args, kk=7)
    torch.cuda.synchronize()
    _assert_ivf_close(args, 7, dk, ik)


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,C,nprobe,mode", [
    (1, 1024, 16, "distinct"), (64, 1024, 16, "distinct"),
    (64, 1024, 16, "skewed"), (64, 7, 16, "repeat"), (3, 2, 40, "repeat"),
    (512, 1024, 16, "distinct"), (512, 100, 16, "distinct")])
def test_ivf_scan_plan_kernel_matches_work_plan(cuda_device, Nq, C, nprobe,
                                                mode):
    """The plan the card makes (order, group starts, counts, segments)
    equals ``work_plan``'s, and its group count stays within the grid's
    bound."""
    rng = np.random.RandomState(Nq + C)
    probes = _probes(rng, Nq, C, nprobe, cuda_device, mode)
    if mode == "repeat":
        probes[:, -1] = C + 3
        probes[0, 0] = -2
    got = device_plan(probes, C)
    (_, *want), = work_plan(probes.cpu(), C)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(got[1]) <= max_groups(Nq * nprobe, C)


def _pq(seed, Nq, C, cap, S, bits, nprobe, lo, hi, device,
        mode="distinct"):
    rng = np.random.RandomState(seed)
    K = 1 << bits
    ids = _segments(rng, C, cap, lo, hi, device)
    real = (ids >= 0).cpu().numpy()
    codes = rng.randint(0, K, (C, cap, S)) * real[..., None]
    t = np.where(real, rng.randn(C, cap), BIG)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(rng.randn(Nq, S * K), **f32),
            torch.tensor(np.abs(rng.randn(Nq, nprobe)), **f32),
            _probes(rng, Nq, C, nprobe, device, mode),
            torch.tensor(codes.astype(np.uint8), device=device),
            torch.tensor(t, **f32), ids)


PQ_SHAPES = [(5, 6, 32, 4, 8, 3, 7, 32, 32), (4, 7, 16, 2, 8, 2, 32, 0, 5),
             (3, 4, 16, 5, 1, 2, 6, 8, 16), (2, 4, 8, 3, 4, 3, 24, 2, 8),
             (9, 12, 300, 100, 8, 6, 1, 0, 300),
             (9, 12, 300, 100, 8, 6, 256, 0, 300),
             (9, 12, 300, 100, 8, 6, 257, 0, 300),
             (3, 12, 300, 100, 8, 6, 1024, 0, 300),
             (5, 8, 300, 200, 8, 4, 50, 100, 300),
             (2, 4, 64, 1000, 8, 3, 20, 30, 64),
             (64, 20, 1224, 100, 8, 16, 50, 1000, 1224),
             (1, 20, 1224, 100, 8, 16, 50, 1000, 1224)]


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,C,cap,S,bits,nprobe,kk,lo,hi", PQ_SHAPES)
def test_pq_adc_kernel_bit_identical_to_plain_version(
        cuda_device, Nq, C, cap, S, bits, nprobe, kk, lo, hi):
    args = _pq(Nq + C + cap, Nq, C, cap, S, bits, nprobe, lo, hi,
               cuda_device)
    before = pq_adc_topk_fused.launches
    dk, ik = pq_adc_topk(*args, kk=kk)
    dp, ip = pq_adc_topk_ref(*args, kk)
    torch.cuda.synchronize()
    assert pq_adc_topk_fused.launches == before + 1
    assert torch.equal(dk, dp) and torch.equal(ik, ip)


# (probes, Nq, C, cap, S, bits, nprobe, kk, lo, hi): every query on the
# same clusters (lists and the wide path), ids repeated in a row, S 128
# (the whole table beside one code tile), Nq 1 at the serving widths, and
# at kk 256 (80 lists of 256: merged in batches of 64)
PQ_PLAN_SHAPES = [("skewed", 64, 48, 300, 100, 8, 16, 50, 200, 300),
                  ("skewed", 8, 48, 300, 100, 8, 16, 512, 200, 300),
                  ("repeat", 9, 12, 300, 100, 8, 6, 40, 0, 300),
                  ("repeat", 5, 6, 32, 4, 8, 6, 7, 20, 32),
                  ("distinct", 4, 8, 600, 128, 8, 4, 256, 300, 600),
                  ("distinct", 1, 48, 1224, 100, 8, 16, 50, 1000, 1224),
                  ("distinct", 1, 48, 1224, 100, 8, 16, 256, 1000, 1224)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,Nq,C,cap,S,bits,nprobe,kk,lo,hi",
                         PQ_PLAN_SHAPES)
def test_pq_adc_kernel_bit_identical_at_the_plans_edges(
        cuda_device, mode, Nq, C, cap, S, bits, nprobe, kk, lo, hi):
    args = _pq(Nq + cap, Nq, C, cap, S, bits, nprobe, lo, hi, cuda_device,
               mode)
    dk, ik = pq_adc_topk(*args, kk=kk)
    dp, ip = pq_adc_topk_ref(*args, kk)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp) and torch.equal(ik, ip)


@pytest.mark.cuda
def test_segment_scans_refuse_what_they_cannot_do(cuda_device):
    # kk past the widest shared list and up to the pool, and a 204,800-byte
    # table (S 200), now run; only a kk past the probed pool is refused
    args = _ivf(0, 2, 4, 300, 16, 2, 300, 300, cuda_device)
    dk, ik = ivf_scan_topk(*args, kk=600)
    assert torch.equal(ik, ivf_scan_topk_ref(*args, 600)[1])
    with pytest.raises(ValueError, match="nprobe"):
        ivf_scan_topk(*args, kk=601)
    args = _pq(0, 2, 4, 300, 8, 8, 2, 300, 300, cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(
        pq_adc_topk(*args, kk=257), pq_adc_topk_ref(*args, 257)))
    with pytest.raises(ValueError, match="nprobe"):
        pq_adc_topk(*args, kk=601)
    args = _pq(0, 2, 4, 300, 200, 8, 2, 300, 300, cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(
        pq_adc_topk(*args, kk=10), pq_adc_topk_ref(*args, 10)))


def _clustered(device, M=3000, d=48, k=16, blobs=20, seed=0):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(blobs, d)
    G = centers[rng.randint(0, blobs, M)] + 0.3 * rng.randn(M, d)
    L = rng.randn(k, d) / np.sqrt(d)
    q = G[rng.randint(0, M, 40)] + 0.1 * rng.randn(40, d)
    return (torch.tensor(a, dtype=torch.float32, device=device)
            for a in (L, G, q))


@pytest.mark.cuda
def test_ann_indexes_on_the_card_launch_their_kernels(cuda_device):
    L, G, q = _clustered(cuda_device)
    ivf = IVFIndex.build(L, G, n_clusters=16, nprobe=16, iters=4)
    before = ivf_scan_topk_fused.launches
    d, i = ivf.topk(q, 10)                       # full probe: exact
    assert ivf_scan_topk_fused.launches == before + 1
    d_e, i_e = metric_topk_plain(L, q, *project_gallery(L, G), 10)
    assert torch.equal(i, i_e)
    pq = IVFPQIndex.build(L, G, n_clusters=16, nprobe=16, n_subspaces=4,
                          bits=6, rerank_depth=LIST_K, iters=4)
    before = pq_adc_topk_fused.launches
    d, i = pq.topk(q, 10)                        # full probe, deep rerank
    assert pq_adc_topk_fused.launches == before + 1
    assert recall_at_k(i.cpu().numpy(), i_e.cpu().numpy()) > 0.9
    with pytest.raises(ValueError, match="xla"):
        ivf.topk(q, 10, scan_impl="xla")
    with pytest.raises(ValueError, match="xla"):
        pq.topk(q, 10, scan_impl="xla")
    with pytest.raises(ValueError, match="xla"):
        IVFIndex.build(L, G, n_clusters=16, scan_impl="xla")
    ivf.topk(q, 10, scan_impl="pallas")


@pytest.mark.cuda
def test_ivfpq_reranks_past_the_widest_list(cuda_device):
    """rerank_depth 512 (pq_adc at kk 512, the wide path): its ADC
    candidates equal the plain version's, and the exact rerank of a
    superset of rerank 50's candidates recalls no less."""
    L, G, q = _clustered(cuda_device)
    pq = IVFPQIndex.build(L, G, n_clusters=16, nprobe=8, n_subspaces=4,
                          bits=6, rerank_depth=512, iters=4)
    d_e, i_e = metric_topk_plain(L, q, *project_gallery(L, G), 10)
    before = pq_adc_topk_fused.launches
    _, i512 = pq.topk(q, 10)
    _, i50 = pq.topk(q, 10, rerank=50)
    assert pq_adc_topk_fused.launches == before + 2
    r512, r50 = (recall_at_k(i.cpu().numpy(), i_e.cpu().numpy())
                 for i in (i512, i50))
    assert r512 >= r50 and r512 > 0.9


@pytest.mark.cuda
def test_ivf_build_on_the_card_is_deterministic(cuda_device):
    """Two IVF builds over the same projected rows on the card give the
    same centroids and segments bit for bit (the k-means cluster sums
    must not depend on the order the card adds rows in): what a tenant's
    promote, bit-identical to a fresh build, rests on."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    gp = torch.randn((262_144, 64), generator=g, device=cuda_device)
    gp += 3.0 * torch.randn((256, 64), generator=g, device=cuda_device)[
        torch.randint(0, 256, (262_144,), generator=g, device=cuda_device)]
    gn = torch.sum(gp * gp, dim=1)
    L = torch.eye(64, device=cuda_device)
    a, b = (IVFIndex.build_projected(L, gp, gn, n_clusters=256, nprobe=16)
            for _ in range(2))
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.ids_pad, b.ids_pad)
    assert torch.equal(a.gp_pad, b.gp_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_ladder_knobs_reach_the_segment_scans(cuda_device, kind,
                                              monkeypatch):
    """A RequestScheduler over a card index, driven on FakeClock until its
    ladder steps down: every batch launches the scan kernel once, with the
    nprobe and kk of the knobs that batch ran with."""
    import threading
    from repro_torch.serve import (FakeClock, RequestScheduler,
                                   RetrievalEngine)
    from repro_torch.serve import ivf as ivf_mod
    from repro_torch.serve import pq as pq_mod
    L, G, q = _clustered(cuda_device)
    if kind == "ivf":
        idx = IVFIndex.build(L, G, n_clusters=16, nprobe=8, iters=4)
        mod, name, kern = ivf_mod, "ivf_scan_topk", ivf_scan_topk_fused
    else:
        idx = IVFPQIndex.build(L, G, n_clusters=16, nprobe=8, n_subspaces=4,
                               bits=6, rerank_depth=40, iters=4)
        mod, name, kern = pq_mod, "pq_adc_topk", pq_adc_topk_fused
    scans, real = [], getattr(mod, name)

    def spy(*args, kk, **kw):
        scans.append((args[1 if kind == "ivf" else 2].shape[1], kk))
        return real(*args, kk=kk, **kw)

    monkeypatch.setattr(mod, name, spy)
    gate, entered, knobs = threading.Event(), threading.Event(), []

    class Gated(RetrievalEngine):
        def search(self, queries, k_top=None, *, span=None, **kw):
            entered.set()
            assert gate.wait(timeout=60)
            knobs.append(kw)
            return super().search(queries, k_top, span=span, **kw)

    eng = Gated(idx, k_top=10, cache_size=0)
    sched = RequestScheduler(eng, clock=FakeClock(), max_batch=2,
                             max_wait_ms=0.0, high_watermark=2,
                             low_watermark=1, degrade_window_s=0.0)
    try:
        before = kern.launches
        plug = sched.submit(q[0].cpu().numpy(), priority="mining")
        assert entered.wait(timeout=60)
        futs = [sched.submit(row) for row in q[1:13].cpu().numpy()]
        gate.set()
        for f in [plug] + futs:
            f.result(timeout=120)
    finally:
        assert sched.close()
    assert kern.launches - before == len(knobs) == len(scans)
    assert any(knobs), "the ladder never stepped down"
    for kw, (nprobe, kk) in zip(knobs, scans):
        assert kw in sched.controller.ladder
        assert nprobe == kw.get("nprobe", idx.nprobe)
        assert kk == (10 if kind == "ivf" else
                      max(10, kw.get("rerank", idx.rerank_depth)))


@pytest.mark.cuda
def test_tenant_promote_on_an_ivf_view_is_bit_identical(cuda_device):
    """Promote an IVF tenant's shadow arm on the card: its answers equal,
    bit for bit, a fresh build of the candidate's view in a second router
    over the same store (the k-means behind both builds must not depend
    on the order the card adds rows in)."""
    from repro_torch.serve import TenantRouter
    g = torch.Generator(device=cuda_device).manual_seed(1)
    G = torch.randn((262_144, 64), generator=g, device=cuda_device)
    G += 3.0 * torch.randn((256, 64), generator=g, device=cuda_device)[
        torch.randint(0, 256, (262_144,), generator=g, device=cuda_device)]
    L0, L1 = (torch.randn((32, 64), generator=g, device=cuda_device) / 8
              for _ in range(2))
    kw = dict(n_clusters=256, nprobe=16)
    router = TenantRouter(G, copy=False)
    router.add_tenant("a", L0, backend="ivf", build_kwargs=kw)
    q = (G[:64] + 0.1).cpu().numpy()
    router.search("a", q)
    router.register_shadow("a", L1, sample_rate=1.0)
    router.search("a", q)                       # mirrored: builds the arm
    router.promote("a")
    fresh = TenantRouter(G, copy=False)
    fresh.add_tenant("f", L1, backend="ivf", build_kwargs=kw)
    assert fresh._blocks[0].data_ptr() == router._blocks[0].data_ptr()
    d_live, i_live = router.search("a", q)
    d_fresh, i_fresh = fresh.search("f", q)
    np.testing.assert_array_equal(i_live, i_fresh)
    np.testing.assert_array_equal(d_live, d_fresh)
    assert router.memory()["gallery"] == G.nbytes + G.shape[0]


def _assert_same_neighbours(mut, q, d, i, d_ref, i_ref):
    """A card answer (d, i) against the CPU port's (d_ref, i_ref), external
    ids: distances within atol + rtol * (qn + gn); where the ids differ,
    the card's neighbour lies at the CPU's distance of that rank (a tie)."""
    gp, gn, live, _ = mut._live_state()
    qp = torch.as_tensor(q).cpu() @ mut.L.cpu().T
    qn = torch.sum(qp * qp, dim=1)[:, None]
    rows = torch.from_numpy(np.searchsorted(live, i.cpu().numpy()))
    tol = ATOL + RTOL * (qn + gn.cpu()[rows])
    assert bool(((d.cpu() - d_ref).abs() <= tol).all())
    d_own = torch.sum(torch.square(qp[:, None, :] - gp.cpu()[rows]), dim=2)
    differ = i.cpu() != i_ref
    assert bool(((d_own - d_ref).abs() <= tol)[differ].all())


@pytest.mark.cuda
@pytest.mark.parametrize("base", ["exact", "ivf", "ivfpq"])
def test_mutable_on_the_card_matches_the_cpu_port(cuda_device, base):
    """One op sequence (upsert, delete, update, fold, swap_metric) on a
    card MutableIndex and a CPU one from the same numpy rows; IVF and
    IVFPQ at nprobe = n_clusters with a rerank over every probed row."""
    from repro_torch.serve import MutableIndex
    L, G, q = (t.cpu().numpy() for t in _clustered(cuda_device))
    kw = {"exact": {}, "ivf": dict(n_clusters=16, nprobe=16, iters=4),
          "ivfpq": dict(n_clusters=16, nprobe=16, n_subspaces=4, bits=6,
                        rerank_depth=5000, iters=4)}[base]
    muts = [MutableIndex.build(L, G, base=base, retain_raw=True,
                               auto_compact_delta=0, auto_compact_dead=0,
                               device=dev, **kw)
            for dev in (cuda_device, "cpu")]
    rng = np.random.RandomState(3)
    kernel = {"exact": metric_topk_fused, "ivf": ivf_scan_topk_fused,
              "ivfpq": pq_adc_topk_fused}[base]
    new, upd = (rng.randn(n, G.shape[1]).astype(np.float32)
                for n in (300, 20))
    L_new = (rng.randn(L.shape[0] // 2, L.shape[1]) / 5).astype(np.float32)
    steps = [lambda m: m.upsert(new),
             lambda m: m.delete(np.arange(0, 600, 3)),
             lambda m: m.upsert(upd, ids=np.arange(1, 41, 2)),
             lambda m: m.compact(),
             lambda m: m.swap_metric(L_new, block_rows=1000)]
    for step in steps:
        for m in muts:
            step(m)
        launched = (kernel.launches, metric_topk_fused.launches)
        d, i = muts[0].topk(torch.from_numpy(q), 10)
        torch.cuda.synchronize()
        assert kernel.launches > launched[0]
        if muts[0].delta_rows:                  # the delta scan's kernel
            assert metric_topk_fused.launches > launched[1] + (
                base == "exact")
        d_ref, i_ref = muts[1].topk(torch.from_numpy(q), 10)
        assert d.is_cuda and i.dtype == torch.int64
        _assert_same_neighbours(muts[1], q, d, i, d_ref, i_ref)
        assert muts[0].version == muts[1].version
        assert muts[0].size == muts[1].size


@pytest.mark.cuda
def test_snapshot_round_trip_on_the_card(cuda_device, tmp_path):
    """A card MutableIndex over IVFPQ saved and loaded on the card answers
    bit for bit; loaded on the CPU, it answers as the CPU port does."""
    from repro_torch.serve import MutableIndex, load_index, save_index
    L, G, q = _clustered(cuda_device)
    mut = MutableIndex.build(L, G, base="ivfpq", retain_raw=True,
                             auto_compact_delta=0, auto_compact_dead=0,
                             n_clusters=16, nprobe=16, n_subspaces=4,
                             bits=6, rerank_depth=5000, iters=4)
    mut.upsert(torch.randn(50, G.shape[1], device=cuda_device))
    mut.delete(np.arange(0, 100, 7))
    d_ref, i_ref = mut.topk(q, 10)
    save_index(mut, str(tmp_path))
    loaded = load_index(str(tmp_path), expect_L=L)
    d, i = loaded.topk(q, 10)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    on_cpu = load_index(str(tmp_path), device="cpu")
    d_c, i_c = on_cpu.topk(q.cpu(), 10)
    _assert_same_neighbours(on_cpu, q, d, i, d_c, i_c)


# -- backbone kernels: flash_attention and ssd_scan ---------------------------
# f32 kernel against the f32 plain version: flash rtol 1e-4 / atol 2e-5
# (the reference's bound for its kernel against its oracle; only the
# summation order differs); SSD within SSD_TOL (kernels/ssd_chunk/cases.py).
# bf16 inputs against the plain version computed in f32 from the same bf16
# values, elementwise: the kernel rounds its output to bf16 once (at most
# BF16_ROUND = 2^-8 |out|) and each probability to bf16 before p v while l
# sums the f32 ones, which moves out by at most 2^-8 attention(q, k, |v|),
# so flash within the f32 bound + 2^-8 (|ref| + attention(q, k, |v|)).


def _fa_bound(q, k, v, ref, causal, window, q_offset=0):
    """Elementwise bound on |kernel - ref| for q's dtype."""
    from repro_torch.kernels.flash_attention import attention_ref
    bound = 2e-5 + 1e-4 * ref.abs()
    if q.dtype == torch.bfloat16:
        bound += BF16_ROUND * (ref.abs() + attention_ref(
            q.float(), k.float(), v.float().abs(), causal=causal,
            window=window, q_offset=q_offset))
    return bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,K,dh,causal,window,q_offset", FA_PARITY)
def test_flash_attention_kernel_matches_plain_version(
        cuda_device, B, T, S, H, K, dh, causal, window, q_offset, dtype):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    rng = np.random.RandomState(T + H + dh)
    q, k, v = (torch.tensor(rng.randn(*shape), dtype=torch.float32,
                            device=cuda_device).to(dtype)
               for shape in ((B, T, H, dh), (B, S, K, dh), (B, S, K, dh)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                        window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, T, H, dh)
    bound = _fa_bound(q, k, v, ref, causal, window, q_offset)
    assert bool(((out.float() - ref).abs() <= bound).all())


@pytest.mark.cuda
def test_flash_attention_reads_strided_views(cuda_device):
    """q, k, v as views into one fused (B, T, 3, H, Dh) projection."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    qkv = torch.randn(2, 96, 3, 4, 32, device=cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = flash_attention(q, k, v, causal=True, window=40)
    ref = attention_ref(q, k, v, causal=True, window=40)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,causal,window,dh", PARITY_PLANS + EDGE_PLANS)
def test_flash_attention_tile_plan_is_the_kernels(cuda_device, T, S, causal,
                                                  window, dh):
    """The CUDA source's own skip / edge / full classification (its
    kv_tiles and full_tile, run on the host) against the brute-force mask,
    and equal to kernel.py's tile_plan, which the CPU tests check."""
    from repro_torch.kernels.flash_attention.kernel import (kernel_tile_plan,
                                                            tile_plan)
    plan = kernel_tile_plan(T, S, causal, window, dh)
    check_plan_against_mask(plan, T, S, causal, window, dh)
    np.testing.assert_array_equal(plan, tile_plan(T, S, causal, window, dh))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,causal,window,dh,q_offset", OFFSET_PLANS)
def test_flash_attention_tile_plan_at_an_offset_is_the_kernels(
        cuda_device, T, S, causal, window, dh, q_offset):
    """As above for a query slice whose rows start at ``q_offset``."""
    from repro_torch.kernels.flash_attention.kernel import (kernel_tile_plan,
                                                            tile_plan)
    plan = kernel_tile_plan(T, S, causal, window, dh, q_offset)
    check_plan_against_mask(plan, T, S, causal, window, dh, q_offset)
    np.testing.assert_array_equal(
        plan, tile_plan(T, S, causal, window, dh, q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [80, 256])
def test_flash_attention_reads_strided_bf16_views(cuda_device, dh):
    """The bf16 kernel's tensor maps over views into one fused (B, T, 3,
    H, Dh) projection: position stride 3 H Dh, a k / v offset of H Dh."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    rng = np.random.RandomState(dh)
    qkv = torch.tensor(rng.randn(2, 200, 3, 4, dh), dtype=torch.float32,
                       device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = flash_attention(q, k, v, causal=True, window=40)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True,
                        window=40)
    torch.cuda.synchronize()
    bound = _fa_bound(q, k, v, ref, True, 40)
    assert bool(((out.float() - ref).abs() <= bound).all())


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_cannot_do(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 16, 4, 64, device=cuda_device)
    for bad in (torch.randn(1, 16, 4, 72, device=cuda_device),      # Dh
                torch.randn(1, 16, 3, 64, device=cuda_device)):     # H % K
        with pytest.raises(ValueError):
            flash_attention(q, bad, bad)
    with pytest.raises(ValueError, match="not one of"):
        big = torch.randn(1, 16, 4, 144, device=cuda_device)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="forward-only"):
        flash_attention(q.clone().requires_grad_(), q, q)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, q, q, q_offset=-1)
    with pytest.raises(ValueError, match="see no key"):
        flash_attention(q, q, q, window=4, q_offset=4)


def _ssd_check(y, h, xs, Bm, Cm, dt, la):
    """y (B, H, T, p) and h of the kernel against ssd_scan_chunked in
    float64 on the same values, pane layout; B and C may be expanded
    views."""
    yr, hr = ssd_cases.reference(xs, Bm, Cm, dt, la)
    torch.cuda.synchronize()
    assert y.dtype == xs.dtype and y.shape == xs.shape
    torch.testing.assert_close(y.double(), yr, **SSD_TOL[xs.dtype])
    torch.testing.assert_close(h, hr.float(), **SSD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,p,n", SSD_PARITY)
def test_ssd_scan_kernel_matches_plain_version(cuda_device, B, H, T, p, n,
                                               dtype):
    from repro_torch.kernels.ssd_chunk import (ssd_core, ssd_scan,
                                               ssd_scan_chunked)
    xs, Bm, Cm, dt, la = ssd_cases.inputs(B, H, T, p, n, dtype, cuda_device,
                                          seed=B + H + T)
    before = ssd_scan.launches
    y, h = ssd_core(xs, Bm, Cm, dt, la)
    yr, hr = ssd_scan_chunked(xs.float().transpose(1, 2),
                              Bm.float()[:, None], Cm.float()[:, None],
                              dt.transpose(1, 2), la.transpose(1, 2))
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == (B, T, H, p) and y.is_contiguous()
    torch.testing.assert_close(y.float(), yr.transpose(1, 2),
                               **SSD_TOL[dtype])
    torch.testing.assert_close(h, hr, **SSD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,p,n,cps", SSD_PLANNED)
def test_ssd_scan_kernel_under_explicit_plans(cuda_device, B, H, T, p, n,
                                              cps, dtype):
    """Segments forced by an explicit plan: T across segment edges, odd
    head pairs, p 8 / 128, n 8 / 64, up to 32 segments."""
    from repro_torch.kernels.ssd_chunk import ssd_scan
    args = ssd_cases.panes(*ssd_cases.inputs(B, H, T, p, n, dtype,
                                             cuda_device, seed=T + cps,
                                             decay=ssd_cases.SLOW))
    y, h = ssd_scan(*args, chunks_per_segment=cps)
    _ssd_check(y, h, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_plans_agree(cuda_device, dtype):
    """One input under two plans: y within the f32 bound of each other
    (bf16: the two outputs round once each, so they may sit one bf16 step
    apart on top of it)."""
    from repro_torch.kernels.ssd_chunk import ssd_scan
    B, H, T, p, n, plans = SSD_TWO_PLANS
    args = ssd_cases.panes(*ssd_cases.inputs(B, H, T, p, n, dtype,
                                             cuda_device, seed=3,
                                             decay=ssd_cases.SLOW))
    (y1, h1), (y2, h2) = (ssd_scan(*args, chunks_per_segment=c)
                          for c in plans)
    _ssd_check(y1, h1, *args)
    _ssd_check(y2, h2, *args)
    tol = SSD_TOL[torch.float32]
    if dtype == torch.bfloat16:
        tol = dict(rtol=tol["rtol"] + 2 * BF16_ROUND,
                   atol=SSD_TOL[dtype]["atol"])
    torch.testing.assert_close(y1.float(), y2.float(), **tol)
    torch.testing.assert_close(h1, h2, **SSD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_reads_views_tma_cannot_describe(cuda_device, dtype):
    from repro_torch.kernels.ssd_chunk import ssd_scan
    args = ssd_cases.strided(dtype, cuda_device)
    y, h = ssd_scan(*args)
    _ssd_check(y, h, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_takes_b_and_c_per_head(cuda_device, dtype):
    from repro_torch.kernels.ssd_chunk import ssd_scan
    args = ssd_cases.per_head(dtype, cuda_device)
    y, h = ssd_scan(*args, chunks_per_segment=2)
    _ssd_check(y, h, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_takes_growing_states(cuda_device, dtype):
    """la > 0: exp(W_t - W_s) above 1 below the diagonal, over three
    segments."""
    from repro_torch.kernels.ssd_chunk import ssd_scan
    B, H, T, p, n, cps = ssd_cases.GROWING
    args = ssd_cases.panes(*ssd_cases.inputs(B, H, T, p, n, dtype,
                                             cuda_device, seed=11,
                                             decay=ssd_cases.GROW))
    y, h = ssd_scan(*args, chunks_per_segment=cps)
    _ssd_check(y, h, *args)


@pytest.mark.cuda
def test_ssd_scan_refuses_what_it_cannot_do(cuda_device):
    from repro_torch.kernels.ssd_chunk import ssd_scan
    xs, Bm, Cm, dt, la = ssd_cases.inputs(1, 2, 64, 16, 8, torch.float32,
                                          cuda_device, seed=0)
    args = (xs.transpose(1, 2), Bm[:, None].expand(1, 2, 64, 8),
            Cm[:, None].expand(1, 2, 64, 8), dt.transpose(1, 2),
            la.transpose(1, 2))
    with pytest.raises(ValueError, match="forward-only"):
        ssd_scan(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match="p <= 128"):
        wide = torch.randn(1, 2, 64, 144, device=cuda_device)
        ssd_scan(wide, *args[1:])
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(*args[:3], args[3].double(), args[4])
    for bad in (0, -1):
        with pytest.raises(ValueError, match="segments"):
            ssd_scan(*args, chunks_per_segment=bad)


@pytest.mark.cuda
def test_backbone_on_the_card_launches_both_kernels(cuda_device):
    """Reduced zamba2 through the kernels against its plain path on the
    card, f32 (SSD chunk 64 against the config's 128: rtol 2e-3, atol
    2e-4, the reference's bound between those forms)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_scan
    from repro_torch.models import Model
    cfg = get_config("zamba2-2.7b-reduced").replace(
        dtype="float32", ssm_tile_dtype="float32", window=40,
        shared_attn_window=40)
    model = Model(cfg, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda_device)
    n_ssd, n_fa = ssd_scan.launches, flash_attention.launches
    with torch.inference_mode():
        emb = model.embed_pool({"tokens": tokens})
        ref = model.embed_pool({"tokens": tokens}, plain=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches - n_ssd == cfg.n_layers
    assert flash_attention.launches - n_fa == \
        cfg.n_layers // cfg.shared_attn_every
    torch.testing.assert_close(emb, ref, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
def test_gemma_on_the_card_launches_flash_at_head_dim_256(cuda_device):
    """Reduced gemma-7b keeping its head dim of 256 (2 layers, 4 heads),
    f32, through the kernel against its plain path (attention chunked
    there, streamed here: only the summation order differs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model
    cfg = get_config("gemma-7b-reduced").replace(dtype="float32",
                                                 head_dim=256)
    model = Model(cfg, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda_device)
    before = flash_attention.launches
    with torch.inference_mode():
        h, _ = model.hidden({"tokens": tokens})
        ref, _ = model.hidden({"tokens": tokens}, plain=True)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.n_layers
    torch.testing.assert_close(h, ref, rtol=1e-4, atol=1e-5)


def _integer_table(n=2000, d=32, classes=20, seed=0):
    """Integer rows and factor: every projection, norm and distance is an
    exact integer in f32 and in the kernel's 3xTF32 products alike (each
    operand fits a TF32 mantissa), so the card and the CPU rank the rows
    identically, ties going to the smaller id on both."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, (n, d)).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.int32)
    L = rng.randint(-2, 3, (8, d)).astype(np.float32)
    return x, y, L


@pytest.mark.cuda
def test_mined_pairs_on_the_card_equal_the_cpu(cuda_device):
    """HardPairMiner over an exact index on the card (metric_topk) mines
    the pairs it mines over the same index on the CPU (its plain
    version): equal neighborhoods, one host filter."""
    from repro_torch.mining import HardPairMiner, MinerConfig
    from repro_torch.serve import ExactIndex, RetrievalEngine
    x, y, L = _integer_table()
    cfg = MinerConfig(k_neighbors=20, max_negatives=2, max_positives=3)
    results = []
    for dev in ("cpu", cuda_device):
        table = torch.from_numpy(x).to(dev)
        engine = RetrievalEngine(ExactIndex.build(L, table, device=dev),
                                 k_top=21)
        before = metric_topk_fused.launches
        miner = HardPairMiner(engine, table, y, cfg, warmup=False)
        results.append(miner.mine(n_queries=600, seed=0))
        if dev != "cpu":
            assert metric_topk_fused.launches > before
    cpu, card = results
    assert cpu.n_pairs > 0
    for key in ("a", "b", "sim"):
        np.testing.assert_array_equal(card.pairs[key], cpu.pairs[key])


@pytest.mark.cuda
def test_mined_stream_gathers_on_the_card_as_on_the_host(cuda_device):
    """MinedPairSource with its table on the card gathers each batch
    there; the batches equal the host gather's bit for bit."""
    from repro_torch.mining import CurriculumSchedule, MinedPairSource
    x, y, _ = _integer_table()
    x = x + np.random.RandomState(1).rand(*x.shape).astype(np.float32)
    rng = np.random.RandomState(2)
    pool = {"a": rng.randint(0, len(x), 500), "b": rng.randint(0, len(x),
                                                               500),
            "sim": rng.randint(0, 2, 500)}
    sched = CurriculumSchedule(warmup_steps=1, ramp_steps=2,
                               max_mined_frac=0.6)
    streams = []
    for dev in ("cpu", cuda_device):
        src = MinedPairSource(x, y, sched, device=dev)
        src.set_pool(pool)
        streams.append(src.worker_streams(2, 256, seed=3))
    for _ in range(5):
        for host, card in zip(*streams):
            bh, bc = next(host), next(card)
            for key in ("xs", "ys", "sim"):
                assert bc[key].device.type == "cuda"
                assert torch.equal(bc[key].cpu(), bh[key])


@pytest.mark.cuda
def test_closed_loop_on_the_card_launches_its_kernels(cuda_device):
    """A small closed loop on the card: the PS steps launch dml_pair (one
    a worker a step), the mining sweeps metric_topk; one version bump a
    refresh; finite losses."""
    from repro_torch.core import dml
    from repro_torch.core.ps import sync
    from repro_torch.core.ps.trainer import DMLTrainConfig
    from repro_torch.mining import (ClosedLoopConfig, ClosedLoopTrainer,
                                    CurriculumSchedule, MinerConfig)
    x, y, _ = _integer_table()
    x = x / 3.0
    cfg = ClosedLoopConfig(
        train=DMLTrainConfig(dml=dml.DMLConfig(feat_dim=32, proj_dim=8),
                             ps=sync.PSConfig(n_workers=2),
                             batch_size=128, steps=20, lr=1e-2,
                             log_every=5),
        miner=MinerConfig(k_neighbors=10),
        schedule=CurriculumSchedule(warmup_steps=2, ramp_steps=4,
                                    max_mined_frac=0.5),
        refresh_every=8, mine_queries=256)
    clt = ClosedLoopTrainer(cfg, x, y, device=cuda_device)
    v0 = clt.engine.index.version
    n_pair, n_topk = dml_pair_fused.launches, metric_topk_fused.launches
    _, hist = clt.run()
    torch.cuda.synchronize()
    assert dml_pair_fused.launches - n_pair == 2 * 20
    assert metric_topk_fused.launches > n_topk
    assert clt.engine.index.version - v0 == clt.n_refreshes - 1 == 2
    assert np.isfinite([h["loss"] for h in hist["steps"]]).all()


def _perturb_constant(model, seed):
    """Seeded N(0, 0.1^2) noise on every parameter the init leaves
    constant (biases at 0, norm scales at 1), in place."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.numel() > 1 and bool((p == p.reshape(-1)[0]).all()):
                p.add_(0.1 * torch.randn(p.shape, generator=gen,
                                         device=p.device))


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,B,T", [
    ("hubert-xlarge", "embeddings", 2, 1500),
    ("pixtral-12b", "embeddings", 1, 1024),
    ("pixtral-12b", "tokens", 1, 1024)])
def test_vlm_audio_forward_on_the_card_matches_plain(cuda_device, name,
                                                     kind, B, T):
    """hubert-xlarge (non-causal MHA 16 heads of 80, attention biases) and
    pixtral-12b (causal GQA 32/8 at Dh 128) at full width cut to 2
    layers, f32, biases and norms made non-zero: the final hidden state
    through flash_attention (one launch a layer) against the plain
    forward (naive attention), max |a - b| / max |b| within 1e-4 (f32 on
    both sides, only the summation order differs), and embed_pool."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model
    cfg = get_config(name).replace(n_layers=2, dtype="float32")
    model = Model(cfg, device=cuda_device, seed=2)
    _perturb_constant(model, 3)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    if kind == "embeddings":
        batch = {kind: torch.randn((B, T, cfg.d_model), generator=gen,
                                   device=cuda_device)}
    else:
        batch = {kind: torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                     device=cuda_device)}
    before = flash_attention.launches
    with torch.inference_mode():
        h, _ = model.hidden(batch)
        launches = flash_attention.launches - before
        ref, _ = model.hidden(batch, plain=True)
        emb = model.embed_pool(batch)
    torch.cuda.synchronize()
    assert launches == cfg.n_layers
    assert h.shape == (B, T, cfg.d_model) and bool(torch.isfinite(h).all())
    assert float((h - ref).abs().max() / ref.abs().max()) <= 1e-4
    torch.testing.assert_close(emb, ref.mean(1), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,over", [
    ("zamba2-2.7b", dict(ssm_tile_dtype="float32")),
    ("zamba2-2.7b", dict(ssm_tile_dtype="float32", shared_attn_window=8)),
    ("gemma-7b", dict(head_dim=256))])
def test_decode_on_the_card_matches_apply_through_the_kernels(
        cuda_device, name, over):
    """Reduced models decode 24 teacher-forced tokens on the card; every
    step's logits against ``apply`` through the kernels (the SSD's
    chunks against decode's recurrence: rtol 2e-3, atol 2e-4, the
    reference's bound between those forms; dense: attention streamed
    against the cache's naive scores, rtol 1e-4, atol 1e-5), with a ring
    of 8 that wraps for zamba2's shared block."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import Model
    cfg = get_config(name + "-reduced").replace(dtype="float32", **over)
    model = Model(cfg, device=cuda_device, seed=1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda_device)
    out = serve.generate(model, tokens, 16, keep_logits=True)
    seq = torch.cat([tokens, out["tokens"]], dim=1)[:, :-1]
    n_ssd, n_fa = ssd_scan.launches, flash_attention.launches
    with torch.inference_mode():
        full, _ = model.apply({"tokens": seq})
    torch.cuda.synchronize()
    hybrid = cfg.family == "hybrid"
    assert flash_attention.launches - n_fa == (
        cfg.n_layers // cfg.shared_attn_every if hybrid else cfg.n_layers)
    assert ssd_scan.launches - n_ssd == (cfg.n_layers if hybrid else 0)
    tol = dict(rtol=2e-3, atol=2e-4) if hybrid else dict(rtol=1e-4,
                                                         atol=1e-5)
    torch.testing.assert_close(out["step_logits"], full, **tol)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One AdamW step of reduced zamba2 (remat on) on the card and on the
    CPU from the same weights and batch: loss and grad norm within rtol
    1e-4 (f32 on both, TF32 off), the params within the bound of the
    CPU tests against the reference (rtol 1e-4 + atol 1e-4)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.tokens import token_stream
    from repro_torch.launch import steps
    from repro_torch.models import Model
    cfg = get_config("zamba2-2.7b-reduced").replace(
        dtype="float32", ssm_tile_dtype="float32")
    run = RunConfig(lr=1e-3, warmup=0, total_steps=4, remat=True)
    results = []
    for dev in ("cpu", cuda_device):
        model = Model(cfg, device="cpu", seed=3).to(dev)
        opt = steps.make_optimizer(run)
        step = steps.make_train_step(model, opt, run, loss_chunks=2)
        batch = next(token_stream(cfg.vocab_size, 2, 64, device=dev))
        state, m = step(steps.init_train_state(model, opt), batch)
        results.append((state, m))
    (s_cpu, m_cpu), (s_gpu, m_gpu) = results
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=1e-4,
                                   atol=0)
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_checkpoint_round_trip_from_the_card(cuda_device, tmp_path):
    """A train state on the card, saved and restored onto the card: bit
    for bit, every leaf back on the card in its dtype."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("smollm-135m-reduced").replace(dtype="float32")
    model = Model(cfg, device=cuda_device)
    opt = steps.make_optimizer(RunConfig(total_steps=4, warmup=0))
    state = steps.init_train_state(model, opt)
    tree = {"params": state.params, "opt": state.opt_state}
    save_checkpoint(str(tmp_path), 1, tree)
    got, at = restore_checkpoint(str(tmp_path),
                                 tree_map(torch.zeros_like, tree))
    assert at == 1
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_rwkv6_gradient_at_the_decay_clamp_at_full_width(cuda_device):
    """rwkv6-1.6b's time mix at full width (d 2048, 32 heads of 64), B 1,
    T 256, every w0 at +2 so every decay sits at its clamp of -5: above
    each chunk's diagonal the chunked form's factors multiply to e^160.
    The gradients of x and every leaf are finite and within 1e-3 of the
    leaf's largest |b| of the token-by-token recurrence's (the bound of
    the CPU test against the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    cfg = get_config("rwkv6-1.6b").replace(dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = rwkv6.init_rwkv6(cfg, gen)
    p["w0"] = torch.full_like(p["w0"], 2.0)
    x = 0.5 * torch.randn((1, 256, cfg.d_model), generator=gen,
                          device=cuda_device)
    gy = torch.randn(x.shape, generator=gen, device=cuda_device)
    grads = []
    for fn in (rwkv6.apply_rwkv6, rwkv6.apply_rwkv6_ref):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        (fn(live, xl, cfg) * gy).sum().backward()
        grads.append([xl.grad] + [live[k].grad for k in sorted(live)])
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.cuda
def test_rwkv6_decode_on_the_card_matches_apply(cuda_device):
    """rwkv6-1.6b at full width cut to 2 layers, f32: 8 prompt + 16
    greedy tokens through ``launch/serve.generate``; every step's logits
    against ``apply`` on the same tokens (rtol 1e-3, atol 1e-4: the
    chunked wkv against decode's exact recurrence, the reference's bound
    between those forms). ``apply`` runs a multiple of its chunk of 32,
    so the 23 tokens are padded to 32: causal, the padding changes no
    earlier logit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    cfg = get_config("rwkv6-1.6b").replace(dtype="float32", n_layers=2)
    model = Model(cfg, device=cuda_device, seed=1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda_device)
    out = serve.generate(model, tokens, 16, keep_logits=True)
    seq = torch.cat([tokens, out["tokens"]], dim=1)[:, :-1]
    padded = torch.cat([seq, torch.zeros((2, 32 - seq.shape[1]),
                                         dtype=seq.dtype,
                                         device=cuda_device)], dim=1)
    with torch.inference_mode():
        full, _ = model.apply({"tokens": padded})
    torch.testing.assert_close(out["step_logits"], full[:, :seq.shape[1]],
                               rtol=1e-3, atol=1e-4)


def _moe_layer(cuda_device, T=512, seed=0):
    """granite-moe-1b-a400m's MoE layer at full width (32 experts, top 8,
    d 1024, expert d_ff 512), f32, and an input of B 1, T tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m").replace(dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    p = moe.init_moe(cfg, gen)
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=cuda_device)
    return cfg, p, x


@pytest.mark.cuda
def test_moe_grouped_equals_dense_at_full_width(cuda_device):
    """The grouped layer against the every-expert oracle at the config's
    capacity, where no queue overflows (checked): y within rtol 1e-3,
    atol 1e-4 and aux within 1e-4 relative (the reference's own bound,
    ``TestMoE``)."""
    from repro_torch.models import moe
    cfg, p, x = _moe_layer(cuda_device)
    _, topi, _ = moe._route(p["router"], x[0], cfg)
    keep, _ = moe._queue_slots(topi, 0, cfg.n_experts,
                               moe._capacity(x.shape[1], cfg, cfg.n_experts))
    assert bool(keep.all())
    y_g, aux_g = moe.apply_moe(p, x, cfg)
    y_d, aux_d = moe.apply_moe_dense(p, x, cfg)
    torch.testing.assert_close(y_g, y_d, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(aux_g, aux_d, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [2.0, 0.25])
def test_moe_forward_and_backward_are_bit_stable(cuda_device, factor):
    """The grouped layer's forward and backward run twice give equal
    bits, at the config's capacity and at 0.25 (queues overflow): the
    dispatch sets rows, and in the combine's backward only dropped pairs
    collide, each adding an exact 0."""
    from repro_torch.models import moe
    cfg, p, x = _moe_layer(cuda_device, seed=1)
    cfg = cfg.replace(moe_capacity_factor=factor)
    gy = torch.randn(x.shape, device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(2))
    runs = []
    for _ in range(2):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        y, aux = moe.apply_moe(live, xl, cfg)
        (torch.sum(y * gy) + aux).backward()
        runs.append([y.detach(), aux.detach(), xl.grad]
                    + [live[k].grad for k in sorted(live)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_remat_recomputation_routes_as_the_forward(cuda_device,
                                                       monkeypatch):
    """granite-moe at full width cut to 2 layers, bf16 activations, the
    training forward under remat: every layer's routing in the backward's
    recomputation equals the forward's (ties in bf16 logits are common;
    the stable top-k breaks them the same way every time)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe
    cfg = get_config("granite-moe-1b-a400m").replace(n_layers=2)
    model = Model(cfg, device=cuda_device, seed=3)
    seen = []
    route = moe._route

    def recording(router_w, x, cfg_):
        out = route(router_w, x, cfg_)
        seen.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "_route", recording)
    params = model.param_tree()
    live = {k: v.clone().requires_grad_(True) for k, v in
            params["blocks"][0]["moe"].items()}
    params["blocks"] = [dict(params["blocks"][0], moe=live)] + \
        params["blocks"][1:]
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda_device)
    h, aux = model.hidden({"tokens": tokens}, plain=True, remat=True,
                          params=params)
    assert len(seen) == cfg.n_layers
    (h.float().square().mean() + aux["moe_aux"]).backward()
    assert len(seen) == 2 * cfg.n_layers
    # the backward recomputes the last layer first
    for a, b in zip(seen[:cfg.n_layers], reversed(seen[cfg.n_layers:])):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(g).all()) for g in
               (v.grad for v in live.values()))


# -- several ranks sharing the card (launch/mesh.spawn over gloo) -------------

@pytest.mark.cuda
def test_sharded_exact_index_on_the_card(cuda_device):
    import _multirank_ranks as ranks
    from repro_torch.launch.mesh import spawn
    L, q, G = _data(16, 4096, 96, 48, 11, cuda_device)
    gp, gn = project_gallery(L, G)
    inp = {"L": L.cpu().numpy(), "gp": gp.cpu().numpy(),
           "gn": gn.cpu().numpy(), "q": q.cpu().numpy(), "ks": (10, 300)}
    out = spawn(ranks.card_exact, 2, args=(inp,), timeout=300.0)
    qn = torch.sum((q @ L.T) ** 2, dim=1)
    inf = torch.full((q.shape[0], 1), float("inf"), device=cuda_device)
    for r in out:
        assert (r["n_shards"], r["backend"]) == (2, "gloo")
        assert r["device"] == "cuda:0" and r["launches"] >= 2
        assert torch.equal(r["answers"][10][1], out[0]["answers"][10][1])
        for k in inp["ks"]:          # the file's rule, against plain
            dk, ik = (x.to(cuda_device) for x in r["answers"][k])
            dp, ip = metric_topk_plain(L, q, gp, gn, k + 1)
            tol = ATOL + RTOL * (qn[:, None] + gn[ip.long()])
            assert bool(((dk - dp[:, :k]).abs() <= tol[:, :k]).all())
            apart = ((dp[:, :k] - torch.cat([-inf, dp[:, :k - 1]], 1))
                     > tol[:, :k]) & ((dp[:, 1:] - dp[:, :k]) > tol[:, :k])
            assert bool((ik == ip[:, :k])[apart].all())


@pytest.mark.cuda
def test_bsp_copies_bit_identical_across_ranks_on_the_card(cuda_device):
    import _multirank_ranks as ranks
    from repro_torch.launch.mesh import spawn
    d, k = 2048, 256
    L0 = (0.05 * np.random.RandomState(0).randn(k, d)).astype(np.float32)
    out = spawn(ranks.card_bsp, 2, args=(
        {"d": d, "k": k, "B": 256, "steps": 3, "L0": L0},), timeout=300.0)
    for r in out:
        assert r["equal"] and r["moved"] > 0 and r["launches"] == 3
