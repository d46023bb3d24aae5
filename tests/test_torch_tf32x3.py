"""The 3xTF32 products of the Hopper kernels, modelled on the CPU.

``dml_pair``, ``metric_topk`` and ``pairwise_sqdist`` run every product
on the tensor cores as 3xTF32 (``kernels/csrc/tf32x3_sm90.cuh``): each
f32 operand split into a TF32 hi (round to nearest, ties away) and a
TF32 lo of the remainder, hi.lo + lo.hi + hi.hi accumulated in f32.
``_dispatch.tf32x3_matmul`` is that arithmetic in plain torch. Here it
runs at the main path's contraction lengths (d = 21504 for dml_pair,
d_out = 1000 for the metric_topk scan and the kNN eval's
pairwise_sqdist, d_in = 21504 for the projection) and is held, with the
tolerances ``chip_smoke.py`` holds the kernels to, against the port's
f32 plain versions and the JAX package's plain paths on the same numpy
inputs:

  * dml_pair: forward (losses, d2, proj) within rtol 2e-5 / atol 1e-5;
  * metric_topk: distances within atol + rtol * (qn + gn), rtol = atol =
    1e-5, ids equal at every rank whose plain distance is apart from its
    neighbours' by more than that;
  * pairwise_sqdist (N 2000, M 8000, k 1000, the eval shape): the cross
    term in 3xTF32 and the kernel's epilogue max((xn + yn) - 2 cross, 0),
    within atol + rtol * (xn + yn), rtol = atol = 1e-5.

As negative controls, one TF32 product (the lo terms dropped) run
through the same checks at the same widths must fail them.

The model cannot show the tensor cores' own accumulation, which the
kernels promote into an f32 sum every stage; the card's parity checks
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) hold the kernels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.dml_pair import dml_pair_ref as jax_pair_ref
from repro.kernels.metric_topk import metric_topk_xla as jax_metric_topk_xla
from repro.kernels.pairwise_dist import pairwise_sqdist_ref as jax_pairwise_ref

from repro_torch.kernels._dispatch import (_tf32, tf32_split, tf32x3_matmul,
                                           topk_by_distance)
from repro_torch.kernels.dml_pair import dml_pair_ref
from repro_torch.kernels.metric_topk import metric_topk_plain
from repro_torch.kernels.pairwise_dist import pairwise_sqdist_ref

RTOL = ATOL = 1e-5
LAM = 1.3
HINGE_GAP = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _tf32_values(rng, n):
    """f32 values with at most 10 mantissa bits: exactly representable."""
    mant = rng.randint(0, 1 << 10, size=n).astype(np.int64)
    exp = rng.randint(-30, 30, size=n)
    sign = rng.choice([-1.0, 1.0], size=n)
    return (sign * (1.0 + mant / 1024.0) * 2.0 ** exp).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_split_is_exact_on_tf32_values(seed):
    x = _t(_tf32_values(np.random.RandomState(seed), 4096))
    hi, lo = tf32_split(x)
    assert torch.equal(hi, x) and bool((lo == 0).all())


@pytest.mark.parametrize("seed", range(3))
def test_split_keeps_all_but_the_last_bits(seed):
    rng = np.random.RandomState(seed)
    x = _t(rng.randn(4096) * 10.0 ** rng.randint(-5, 5, 4096))
    hi, lo = tf32_split(x)
    for part in (hi, lo):                   # both have 10 mantissa bits
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    # hi is the nearest TF32 value; lo carries the remainder to ~2^-22
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())


def test_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11                  # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12,
                      1.0 + 2.0 ** -11 + 2.0 ** -20, 0.0])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -9, 1.0, 1.0 + 2.0 ** -10, 0.0])
    assert torch.equal(_tf32(x), want)


def test_three_products_beat_one():
    """3xTF32 lands within a few f32 ulps of the f64 product where one
    TF32 product is off by ~2^-11."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(16, 4096), rng.randn(32, 4096)
    exact = a @ b.T
    got = tf32x3_matmul(_t(a), _t(b)).double().numpy()
    one = (_tf32(_t(a)) @ _tf32(_t(b)).T).double().numpy()
    scale = np.abs(a) @ np.abs(b).T
    assert np.max(np.abs(got - exact) / scale) < 2e-6
    assert np.max(np.abs(one - exact) / scale) > 1e-5


def _pairs(B, k, d, seed):
    rng = np.random.RandomState(seed)
    L = (rng.randn(k, d) / np.sqrt(k * d)).astype(np.float32)
    xs = rng.randn(B, d).astype(np.float32)
    ys = rng.randn(B, d).astype(np.float32)
    sim = (np.arange(B) % 2).astype(np.int32)
    rng.shuffle(sim)
    d2 = np.sort(np.sum(((xs - ys).astype(np.float64) @ L.T) ** 2, axis=1))
    i = int(np.argmax(np.diff(d2)))
    margin = float(0.5 * (d2[i] + d2[i + 1]))
    assert np.min(np.abs(d2 - margin)) > HINGE_GAP
    return L, xs, ys, sim, margin


def _tf32x1_matmul(a, b):
    """One TF32 product: what a kernel that dropped the lo terms (a stale
    or unwritten lo buffer) would compute."""
    return _tf32(a) @ _tf32(b).T


def _pair_model(L, xs, ys, sim, lam, margin, matmul=tf32x3_matmul):
    """dml_pair's forward with its product in 3xTF32 (or ``matmul``)."""
    proj = matmul(xs - ys, L)
    d2 = torch.sum(proj * proj, dim=-1)
    simf = sim.to(torch.float32)
    losses = simf * d2 + (1.0 - simf) * lam * torch.clamp_min(margin - d2,
                                                              0.0)
    return losses, d2, proj


@pytest.mark.parametrize("seed", [0, 1])
def test_dml_pair_at_training_width(seed):
    """8 pairs at d = 21504 against k = 1000 L rows (dml-imnet1m)."""
    L, xs, ys, sim, margin = _pairs(8, 1000, 21504, seed)
    model = _pair_model(_t(L), _t(xs), _t(ys), torch.from_numpy(sim), LAM,
                        margin)
    plain = dml_pair_ref(_t(L), _t(xs), _t(ys), torch.from_numpy(sim), LAM,
                         margin)
    ref = jax_pair_ref(jnp.asarray(L), jnp.asarray(xs), jnp.asarray(ys),
                       jnp.asarray(sim), LAM, margin)
    for ours, p, r in zip(model, plain, ref):
        torch.testing.assert_close(ours, p, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-5)


def _topk_model(L, q, gp, gn, k_top, matmul=tf32x3_matmul):
    """metric_topk's arithmetic: both products in 3xTF32 (or ``matmul``),
    qn from the f32 qp, d rounded as (qn + gn) - 2 cross, the (d, id)
    selection."""
    qp = matmul(q, L)
    qn = torch.sum(qp * qp, dim=1)
    d = torch.clamp_min(qn[:, None] + gn[None, :]
                        - 2.0 * matmul(qp, gp), 0.0)
    ids = torch.arange(gp.shape[0], dtype=torch.int32).expand(q.shape[0], -1)
    return topk_by_distance(d, ids, k_top)


def _hold(dk, ik, dp, ip, D, qn, gn, k_top):
    """The chip_smoke rule: distances within atol + rtol (qn + gn); ids
    equal where the plain distance is apart from its neighbours'; at a
    near-tie the returned id carries its rank's plain distance."""
    tol = ATOL + RTOL * (qn[:, None] + gn[ip])
    assert np.all(np.abs(dk - dp) <= tol)
    ext = np.sort(D, axis=1)[:, :k_top + 1]
    lo = np.concatenate([np.full_like(dp[:, :1], -np.inf), dp[:, :-1]], 1)
    apart = ((dp - lo) > tol) & ((ext[:, 1:] - dp) > tol)
    assert np.all((ik == ip)[apart])
    assert np.all(np.abs(np.take_along_axis(D, ik, 1) - dp) <= tol)


def _serving(seed):
    """64 queries (d_in 21504) through L (1000 x 21504) against 4096
    projected gallery rows (d_out 1000), and the plain distances."""
    rng = np.random.RandomState(seed)
    L = (rng.randn(1000, 21504) / np.sqrt(21504)).astype(np.float32)
    q = rng.randn(64, 21504).astype(np.float32)
    gp = rng.randn(4096, 1000).astype(np.float32)
    gn = np.sum(gp.astype(np.float64) ** 2, axis=1).astype(np.float32)
    qp = (_t(q) @ _t(L).T).numpy()
    qn = np.sum(qp * qp, axis=1)
    D = np.maximum(qn[:, None] + gn[None] - 2.0 * qp @ gp.T, 0.0)
    return L, q, gp, gn, qn, D


@pytest.mark.parametrize("seed,k_top", [(0, 10), (1, 256)])
def test_metric_topk_at_serving_width(seed, k_top):
    L, q, gp, gn, qn, D = _serving(seed)
    dk, ik = _topk_model(_t(L), _t(q), _t(gp), _t(gn), k_top)
    dp, ip = metric_topk_plain(_t(L), _t(q), _t(gp), _t(gn), k_top)
    _hold(dk.numpy(), ik.numpy(), dp.numpy(), ip.numpy(), D, qn, gn, k_top)
    rd, ri = jax_metric_topk_xla(jnp.asarray(L), jnp.asarray(q),
                                 jnp.asarray(gp), jnp.asarray(gn), k_top)
    _hold(dk.numpy(), ik.numpy(), np.asarray(rd), np.asarray(ri), D, qn, gn,
          k_top)


def _pairwise_model(xp, yp, matmul=tf32x3_matmul):
    """pairwise_sqdist's arithmetic: the cross term in 3xTF32 (or
    ``matmul``), the row norms in f32, the epilogue (xn + yn) - 2 cross
    clamped at 0."""
    xn, yn = torch.sum(xp * xp, dim=1), torch.sum(yp * yp, dim=1)
    return torch.clamp_min(xn[:, None] + yn[None, :]
                           - 2.0 * matmul(xp, yp), 0.0)


def _eval_points():
    """The kNN eval's shape: 2000 held-out rows against 8000 training
    rows, projected to d_out 1000 (O(1) entries, as projected rows are)."""
    rng = np.random.RandomState(7)
    xp = rng.randn(2000, 1000).astype(np.float32)
    yp = rng.randn(8000, 1000).astype(np.float32)
    tol = ATOL + RTOL * (np.sum(xp.astype(np.float64) ** 2, 1)[:, None]
                         + np.sum(yp.astype(np.float64) ** 2, 1)[None, :])
    return xp, yp, tol


def test_pairwise_sqdist_at_eval_width():
    xp, yp, tol = _eval_points()
    model = _pairwise_model(_t(xp), _t(yp)).numpy()
    plain = pairwise_sqdist_ref(_t(xp), _t(yp)).numpy()
    ref = np.asarray(jax_pairwise_ref(jnp.asarray(xp), jnp.asarray(yp)))
    for other in (plain, ref):
        assert np.all(np.abs(model - other) <= tol)


# Negative controls: the same tolerances reject one TF32 product, so a
# kernel whose lo terms went missing cannot pass parity.

def test_one_tf32_product_fails_at_eval_width():
    xp, yp, tol = _eval_points()
    model = _pairwise_model(_t(xp), _t(yp), matmul=_tf32x1_matmul).numpy()
    plain = pairwise_sqdist_ref(_t(xp), _t(yp)).numpy()
    assert not np.all(np.abs(model - plain) <= tol)

@pytest.mark.parametrize("seed,k_top", [(0, 10), (1, 256)])
def test_one_tf32_product_fails_at_serving_width(seed, k_top):
    L, q, gp, gn, qn, D = _serving(seed)
    dk, ik = _topk_model(_t(L), _t(q), _t(gp), _t(gn), k_top,
                         matmul=_tf32x1_matmul)
    dp, ip = metric_topk_plain(_t(L), _t(q), _t(gp), _t(gn), k_top)
    with pytest.raises(AssertionError):
        _hold(dk.numpy(), ik.numpy(), dp.numpy(), ip.numpy(), D, qn, gn,
              k_top)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_product_fails_at_training_width(seed):
    L, xs, ys, sim, margin = _pairs(8, 1000, 21504, seed)
    model = _pair_model(_t(L), _t(xs), _t(ys), torch.from_numpy(sim), LAM,
                        margin, matmul=_tf32x1_matmul)
    plain = dml_pair_ref(_t(L), _t(xs), _t(ys), torch.from_numpy(sim), LAM,
                         margin)
    # proj misses by about 5x its tolerance (3xTF32: about 2% of it)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(model[2], plain[2], rtol=2e-5, atol=1e-5)
