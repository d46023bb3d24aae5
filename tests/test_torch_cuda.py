"""The port's CUDA kernels against their plain versions, on the card.

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

from repro_torch.kernels.metric_topk import (metric_topk, metric_topk_fused,
                                             metric_topk_plain,
                                             project_gallery)
from repro_torch.kernels.metric_topk.kernel import MAX_K_TOP

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
