"""The port's dml_pair loss (repro_torch) held against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's ``dml_pair_loss_fused`` runs the kernel's plain
forward and the closed-form backward; the reference runs its Pallas
kernel in interpret mode (as tests/test_kernels.py does), its plain
oracle, and ``jax.grad``. Forward within rtol 2e-5 / atol 1e-5, gradients
w.r.t. L, xs, ys within rtol 1e-4 / atol 1e-5 (f32 on both sides,
different summation order). The margin sits between two pairs' d2 so no
pair is within 1e-3 of the hinge, where a correct reordering of the sum
could flip the mask and a whole pair's gradient. The CUDA kernel itself
is checked in tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dml as jax_dml
from repro.kernels.dml_pair import dml_pair_loss_fused as jax_fused
from repro.kernels.dml_pair import dml_pair_loss_reference as jax_reference
from repro.kernels.dml_pair import dml_pair_ref as jax_pair_ref

from repro_torch.core import dml
from repro_torch.kernels.dml_pair import (dml_pair_forward, dml_pair_fused,
                                          dml_pair_loss_and_d2,
                                          dml_pair_loss_fused,
                                          dml_pair_loss_reference,
                                          dml_pair_ref)
from repro_torch.kernels.dml_pair import kernel as dml_kernel
from repro_torch.kernels._dispatch import tma_operand
from repro_torch.kernels.dml_pair.kernel import (BLOCK_K, BLOCK_M, BLOCK_N,
                                                 SMEM_LIMIT, launch_plan,
                                                 smem_bytes)

SHAPES = [(8, 8, 8), (64, 32, 48), (100, 60, 780), (37, 16, 24)]
LAM = 1.3
HINGE_GAP = 1e-3


def _data(B, k, d, seed):
    """Pairs whose d2 is O(1), both sim values present, the margin in the
    middle of the widest gap between consecutive d2 values of the middle
    half (so the hinge is active for about half the pairs)."""
    rng = np.random.RandomState(seed)
    L = (rng.randn(k, d) / np.sqrt(k * d)).astype(np.float32)
    xs = rng.randn(B, d).astype(np.float32)
    ys = rng.randn(B, d).astype(np.float32)
    sim = (np.arange(B) % 2).astype(np.int32)
    rng.shuffle(sim)
    d2 = np.sort(np.sum(((xs - ys).astype(np.float64) @ L.T) ** 2, axis=1))
    lo = B // 4
    i = lo + int(np.argmax(np.diff(d2[lo:max(lo + 2, 3 * B // 4)])))
    margin = float(0.5 * (d2[i] + d2[i + 1]))
    assert np.min(np.abs(d2 - margin)) > HINGE_GAP
    return L, xs, ys, sim, margin


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("B,k,d", SHAPES)
def test_forward_matches_jax_kernel_and_oracle(B, k, d):
    L, xs, ys, sim, margin = _data(B, k, d, seed=B + k + d)
    ref = jax_fused(jnp.asarray(L), jnp.asarray(xs), jnp.asarray(ys),
                    jnp.asarray(sim), LAM, margin)          # interpret mode
    oracle = jax_reference(jnp.asarray(L), jnp.asarray(xs), jnp.asarray(ys),
                           jnp.asarray(sim), LAM, margin)
    out = dml_pair_loss_fused(_t(L), _t(xs), _t(ys), _t(sim), LAM, margin)
    assert out.dtype == torch.float32 and out.dim() == 0
    for r in (ref, oracle):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-5)
    # the per-pair outputs of the plain version against the JAX oracle
    losses, d2, proj = dml_pair_ref(_t(L), _t(xs), _t(ys), _t(sim), LAM,
                                    margin)
    for ours, theirs in zip((losses, d2, proj),
                            jax_pair_ref(jnp.asarray(L), jnp.asarray(xs),
                                         jnp.asarray(ys), jnp.asarray(sim),
                                         LAM, margin)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("B,k,d", SHAPES)
def test_gradients_match_jax(B, k, d):
    L, xs, ys, sim, margin = _data(B, k, d, seed=7 + B)
    args = (jnp.asarray(L), jnp.asarray(xs), jnp.asarray(ys),
            jnp.asarray(sim), LAM, margin)
    g_kernel = jax.grad(jax_fused, argnums=(0, 1, 2))(*args)
    g_oracle = jax.grad(jax_reference, argnums=(0, 1, 2))(*args)
    Lt, xt, yt = (_t(a).requires_grad_(True) for a in (L, xs, ys))
    dml_pair_loss_fused(Lt, xt, yt, _t(sim), LAM, margin).backward()
    for ours, jk, jo in zip((Lt.grad, xt.grad, yt.grad), g_kernel, g_oracle):
        for theirs in (jk, jo):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,k,d", SHAPES)
def test_closed_form_equals_autograd_and_analytic_grad(B, k, d):
    L, xs, ys, sim, margin = _data(B, k, d, seed=11 + d)
    Lt = _t(L).requires_grad_(True)
    dml_pair_loss_fused(Lt, _t(xs), _t(ys), _t(sim), LAM, margin).backward()
    closed = Lt.grad.clone()
    Lt.grad = None
    dml_pair_loss_reference(Lt, _t(xs), _t(ys), _t(sim), LAM,
                            margin).backward()
    autograd = Lt.grad
    analytic = dml.analytic_grad(_t(L), _t(xs), _t(ys), _t(sim), LAM, margin)
    jax_analytic = jax_dml.analytic_grad(jnp.asarray(L), jnp.asarray(xs),
                                         jnp.asarray(ys), jnp.asarray(sim),
                                         LAM, margin)
    for a in (autograd, analytic):
        np.testing.assert_allclose(closed.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(analytic.numpy(), np.asarray(jax_analytic),
                               rtol=1e-4, atol=1e-5)


def test_loss_and_d2_returns_the_forwards_distances():
    L, xs, ys, sim, margin = _data(37, 16, 24, seed=3)
    loss, d2 = dml_pair_loss_and_d2(_t(L), _t(xs), _t(ys), _t(sim), LAM,
                                    margin)
    losses, d2_ref, _ = dml_pair_forward(_t(L), _t(xs), _t(ys), _t(sim), LAM,
                                         margin)
    assert torch.equal(d2, d2_ref) and not d2.requires_grad
    assert torch.equal(loss, torch.mean(losses))


def test_only_the_needed_gradients_are_computed():
    L, xs, ys, sim, margin = _data(8, 8, 8, seed=0)
    Lt = _t(L).requires_grad_(True)
    xt = _t(xs)
    dml_pair_loss_fused(Lt, xt, _t(ys), _t(sim), LAM, margin).backward()
    assert Lt.grad is not None and xt.grad is None


@pytest.mark.parametrize("bad", ["cpu", "noncontiguous", "float64"])
def test_cuda_wrapper_refuses_without_launching(bad):
    L, xs, ys, sim, _ = _data(37, 16, 24, seed=5)
    L, xs, ys, sim = _t(L), _t(xs), _t(ys), _t(sim)
    if bad == "noncontiguous":
        xs = xs.T.contiguous().T
    elif bad == "float64":
        xs = xs.double()
    before = dml_pair_fused.launches
    match = {"cpu": "CUDA tensors", "noncontiguous": "contiguous",
             "float64": "float32"}[bad]
    with pytest.raises(ValueError, match=match):
        dml_pair_fused(L, xs, ys, sim, lam=LAM)
    assert dml_pair_fused.launches == before
    assert dml_kernel._lib is None          # nothing was built or loaded


@pytest.mark.parametrize("B,d,k", [(1000, 21504, 1000), (37, 24, 16),
                                   (8, 8, 8), (4000, 780, 600),
                                   (1, 100000, 1), (1000, 2048, 1000),
                                   (129, 36, 257), (256, 12, 128)])
def test_split_plan_covers_every_column(B, d, k):
    """The launch plan: a grid of every (pair, L-row) tile, d slices that
    are whole 32-column stages covering d exactly once, one wave of
    blocks at most where d allows it, and a block within 227 KB."""
    plan = launch_plan(B, d, k, n_sm=132)
    gx, gy, gz = plan.grid
    assert (gx - 1) * BLOCK_M < B <= gx * BLOCK_M
    assert (gy - 1) * BLOCK_N < k <= gy * BLOCK_N
    assert gz == plan.ksplit >= 1 and plan.kchunk % BLOCK_K == 0
    assert (plan.ksplit - 1) * plan.kchunk < d <= plan.ksplit * plan.kchunk
    assert gx * gy * gz <= max(132, gx * gy)
    assert smem_bytes() <= SMEM_LIMIT


def test_split_plan_fills_the_card_at_training_width():
    plan = launch_plan(1000, 21504, 1000, n_sm=132)
    assert plan.grid == (8, 8, 2) and plan.kchunk == 10752
    # 4 raw stages of 48 KB (xs, ys, L) and two 16 KB lo buffers of L
    assert smem_bytes() == 1024 + 4 * 49152 + 2 * 16384 + 64


@pytest.mark.parametrize("d", [9, 33, 1, 24])
def test_wrapper_pads_rows_to_the_tma_stride(d):
    """Rows not a multiple of 4 floats get zero columns (a copy); the
    padded operands give the same products and norms, and the plan
    covers the padded width."""
    L, xs, ys, sim, margin = _data(37, 16, d, seed=d)
    Lp, xp, yp = (tma_operand(_t(a)) for a in (L, xs, ys))
    d4 = -(-d // 4) * 4
    assert Lp.shape == (16, d4) and xp.shape == (37, d4)
    assert bool((xp[:, d:] == 0).all()) and torch.equal(xp[:, :d], _t(xs))
    x = _t(xs)
    assert (tma_operand(x) is x) == (d % 4 == 0)  # no copy when aligned
    out = dml_pair_ref(Lp, xp, yp, _t(sim), LAM, margin)
    ref = dml_pair_ref(_t(L), _t(xs), _t(ys), _t(sim), LAM, margin)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-5)
    plan = launch_plan(37, d4, 16, n_sm=132)
    assert (plan.ksplit - 1) * plan.kchunk < d4 <= plan.ksplit * plan.kchunk
