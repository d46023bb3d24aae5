"""The port's CUDA kernels against their plain versions, on the card:
metric_topk, dml_pair (forward and gradients) and pairwise_sqdist.

Marked ``cuda``: without a card every test here skips (a CUDA kernel has
no CPU mode). Run on a machine with one card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports torch and the port only (no jax), so it also runs where
the JAX reference is not installed. Comparison rule, f32 on both sides
with a different summation order: distances within atol + rtol *
(qn_i + gn_j), rtol = atol = 1e-5 (the rounding of qn + gn - 2 qp.gp
scales with its operands); ids equal at every rank whose plain distance
is apart from its neighbours' by more than that.
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
from repro_torch.kernels.metric_topk.kernel import MAX_K_TOP
from repro_torch.kernels.pairwise_dist import (pairwise_sqdist,
                                               pairwise_sqdist_any,
                                               pairwise_sqdist_ref)

RTOL = ATOL = 1e-5
SHAPES = [(64, 1024, 128, 64, 10), (16, 300, 40, 12, 5), (7, 129, 33, 9, 3),
          (200, 2048, 96, 48, 20), (128, 512, 128, 128, 1),
          (8, 96, 24, 8, 96), (3, 5000, 200, 150, MAX_K_TOP),
          (40, 3000, 1000, 1000, 10)]


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


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_do(cuda_device):
    L, q, G = _data(4, 300, 16, 8, 0, cuda_device)
    gp, gn = project_gallery(L, G)
    with pytest.raises(ValueError, match=str(MAX_K_TOP)):
        metric_topk(L, q, gp, gn, k_top=MAX_K_TOP + 1)
    with pytest.raises(ValueError, match="contiguous"):
        metric_topk_fused(q.T.contiguous().T, L, gp, gn, k_top=3)
    with pytest.raises(ValueError, match="float32"):
        metric_topk_fused(q.double(), L, gp, gn, k_top=3)


# -- dml_pair ----------------------------------------------------------------

DML_SHAPES = [(8, 8, 8), (64, 32, 48), (256, 128, 512), (100, 60, 780),
              (512, 600, 780), (32, 100, 224), (37, 16, 24),
              (1000, 1000, 2048)]


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
def test_dml_pair_kernel_is_deterministic_and_refuses_bf16(cuda_device):
    L, xs, ys, sim, margin = _pairs(300, 200, 4000, 0, cuda_device)
    a = dml_pair_fused(L, xs, ys, sim, margin=margin)
    b = dml_pair_fused(L, xs, ys, sim.float(), margin=margin)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="float32"):
        dml_pair_fused(L.bfloat16(), xs, ys, sim)
    with pytest.raises(ValueError, match="float32"):
        losses.dml_pair_loss(L, {"xs": xs, "ys": ys, "sim": sim},
                             compute_dtype=torch.bfloat16)


# -- pairwise_sqdist ---------------------------------------------------------

PD_SHAPES = [(64, 128, 32), (37, 129, 9), (1, 7, 3), (256, 512, 520),
             (100, 300, 1000), (2000, 8000, 1000), (65, 200, 21504)]


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
