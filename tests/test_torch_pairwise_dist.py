"""The port's pairwise distances and kNN / k-means evaluation held
against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU ``metric_sqdist_matrix`` runs the kernel's plain version; the
reference runs its Pallas kernel in interpret mode where its wrapper
takes it (N and M multiples of 8) and its plain oracle elsewhere.
Distances: |D - D_ref| <= atol + rtol * (||xp_i||^2 + ||yp_j||^2) with
rtol = atol = 1e-5 (the f32 rounding of xn + yn - 2 xp.yp scales with
its operands, not with the cancelling result). Predictions, assignments
and purities must be equal. The CUDA kernel itself is checked in
tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import eval_tasks as jax_eval
from repro.data import pairs as jax_pairs
from repro.kernels.pairwise_dist import metric_sqdist_matrix as jax_matrix
from repro.kernels.pairwise_dist import pairwise_sqdist as jax_kernel

from repro_torch.core import eval_tasks
from repro_torch.kernels.pairwise_dist import (metric_sqdist_matrix,
                                               pairwise_sqdist,
                                               pairwise_sqdist_any,
                                               pairwise_sqdist_ref)
from repro_torch.kernels.pairwise_dist import kernel as pd_kernel

RTOL = ATOL = 1e-5


def _data(N, M, d, k, seed):
    rng = np.random.RandomState(seed)
    return ((0.3 * rng.randn(k, d)).astype(np.float32),
            rng.randn(N, d).astype(np.float32),
            rng.randn(M, d).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _assert_close(D, D_ref, xp, yp):
    xn = np.sum(np.asarray(xp, np.float64) ** 2, axis=1)
    yn = np.sum(np.asarray(yp, np.float64) ** 2, axis=1)
    tol = ATOL + RTOL * (xn[:, None] + yn[None, :])
    assert D.shape == D_ref.shape
    assert (np.abs(D - D_ref) <= tol).all()


@pytest.mark.parametrize("N,M,d,k", [
    (64, 128, 48, 32),          # the JAX kernel runs (multiples of 8)
    (16, 40, 33, 12),
    (256, 512, 96, 520),        # k above one 512 contraction tile
    (37, 129, 20, 9),           # ragged: the JAX wrapper takes its oracle
    (1, 7, 5, 3),
    (100, 30, 64, 64),
])
def test_metric_sqdist_matrix_matches_jax(N, M, d, k):
    L, x, y = _data(N, M, d, k, seed=N + M + k)
    D_ref = np.asarray(jax_matrix(jnp.asarray(L), jnp.asarray(x),
                                  jnp.asarray(y)))
    D = metric_sqdist_matrix(_t(L), _t(x), _t(y))
    assert D.dtype == torch.float32 and (D.numpy() >= 0).all()
    _assert_close(D.numpy(), D_ref, x @ L.T, y @ L.T)


@pytest.mark.parametrize("N,M,k", [(64, 256, 128), (8, 16, 1000)])
def test_plain_version_matches_the_jax_kernel(N, M, k):
    rng = np.random.RandomState(k)
    xp = rng.randn(N, k).astype(np.float32)
    yp = rng.randn(M, k).astype(np.float32)
    D_ref = np.asarray(jax_kernel(jnp.asarray(xp), jnp.asarray(yp),
                                  block_n=8, block_m=16,
                                  block_c=min(k, 512) if k % 512 == 0
                                  else 8))
    D = pairwise_sqdist_any(_t(xp), _t(yp))
    _assert_close(D.numpy(), D_ref, xp, yp)
    assert torch.equal(D, pairwise_sqdist_ref(_t(xp), _t(yp)))


def test_self_distances_clamp_at_zero():
    rng = np.random.RandomState(0)
    xp = _t(rng.randn(20, 30).astype(np.float32) * 100)
    D = pairwise_sqdist_any(xp, xp)
    assert (D >= 0).all()
    assert float(torch.diagonal(D).max()) <= ATOL + RTOL * 2 * float(
        torch.sum(xp ** 2, 1).max())


@pytest.mark.parametrize("bad", ["cpu", "noncontiguous", "float64"])
def test_cuda_wrapper_refuses_without_launching(bad):
    rng = np.random.RandomState(1)
    xp = _t(rng.randn(16, 8).astype(np.float32))
    yp = _t(rng.randn(24, 8).astype(np.float32))
    if bad == "noncontiguous":
        xp = xp.T.contiguous().T
    elif bad == "float64":
        xp = xp.double()
    before = pairwise_sqdist.launches
    match = {"cpu": "CUDA tensors", "noncontiguous": "contiguous",
             "float64": "float32"}[bad]
    with pytest.raises(ValueError, match=match):
        pairwise_sqdist(xp, yp)
    assert pairwise_sqdist.launches == before
    assert pd_kernel._lib is None           # nothing was built or loaded


@pytest.fixture(scope="module")
def labelled():
    cfg = dict(n_samples=600, feat_dim=32, n_classes=6, kind="noisy_subspace",
               noise=0.5, seed=4)
    x, y = jax_pairs.make_features(jax_pairs.PairDatasetConfig(**cfg))
    L = (np.random.RandomState(9).randn(12, 32) / 6.0).astype(np.float32)
    return x, y, L


@pytest.mark.parametrize("use_L", [True, False])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_matches_jax(labelled, use_L, k):
    x, y, L = labelled
    train_x, train_y, test_x, test_y = x[:480], y[:480], x[480:], y[480:]
    L_ref = jnp.asarray(L) if use_L else None
    L_pt = _t(L) if use_L else None
    pred_ref = np.asarray(jax_eval.knn_classify(L_ref, train_x, train_y,
                                                test_x, k))
    pred = eval_tasks.knn_classify(L_pt, train_x, train_y, test_x, k,
                                   device="cpu")
    np.testing.assert_array_equal(pred.numpy(), pred_ref)
    # equal predictions; the two means round 1/n-multiples differently
    assert eval_tasks.knn_accuracy(L_pt, train_x, train_y, test_x, test_y, k,
                                   device="cpu") == pytest.approx(
        jax_eval.knn_accuracy(L_ref, train_x, train_y, test_x, test_y, k),
        rel=1e-6)


def test_knn_vote_ties_go_to_the_smaller_index_and_label():
    D = torch.tensor([[1.0, 1.0, 1.0, 0.5], [2.0, 0.0, 2.0, 2.0]])
    train_y = torch.tensor([3, 1, 2, 0])
    # row 0: k=2 takes index 3 then index 0 (ties by index); labels 0, 3
    # tie 1:1, so the smaller label wins; row 1: index 1, then index 0
    assert eval_tasks.knn_vote(D, train_y, k=2).tolist() == [0, 1]
    # all distances equal: indices 0 and 1 (labels 3 and 1) -> label 1
    args = (np.zeros((4, 1), np.float32), np.array([3, 1, 2, 0]),
            np.zeros((1, 1), np.float32))
    ref = jax_eval.knn_classify(jnp.eye(1), *args, k=2)
    ours = eval_tasks.knn_classify(torch.eye(1), *args, k=2, device="cpu")
    assert ours.tolist() == np.asarray(ref).tolist() == [1]


@pytest.mark.parametrize("use_L", [True, False])
def test_metric_kmeans_and_purity_match_jax(labelled, use_L):
    x, y, L = labelled
    a_ref, c_ref = jax_eval.metric_kmeans(jnp.asarray(L) if use_L else None,
                                          x, 6, n_iter=15, seed=2)
    a, c = eval_tasks.metric_kmeans(_t(L) if use_L else None, x, 6,
                                    n_iter=15, seed=2, device="cpu")
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-4,
                               atol=1e-5)
    assert eval_tasks.clustering_purity(a, y) == \
        jax_eval.clustering_purity(a_ref, y)
