"""The port's Fig. 4 baselines (``repro_torch/core/{xing2002,itml,kiss}``)
held against the JAX reference on the same numpy inputs, on the CPU.

  * ``xing2002.pgd_step``: loss and the projected M within rtol 1e-5; the
    reference's ``fit`` replayed step by step through the port's
    ``pgd_step`` on the index sequence of its ``jax.random.split`` chain,
    M within 1e-5 of max |M|;
  * ``itml.fit``: 240 constraints, 2 sweeps, gamma 1e-3 and 1.0, M
    within 1e-4 of max |M|
    (thousands of sequential rank-one updates, each with its own f32
    dot-product order);
  * ``kiss.fit``: M without PCA, and ``proj M projᵀ`` with PCA (the PCA
    axes' signs are arbitrary), within 1e-4 of the largest entry;
  * the port's own ``fit``s: finite and PSD, and Xing's loss falls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import itml as jax_itml
from repro.core import kiss as jax_kiss
from repro.core import xing2002 as jax_xing

from repro_torch.core import itml, kiss, xing2002
from repro_torch.data import pairs

D = 24
CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    cfg = pairs.PairDatasetConfig(n_samples=600, feat_dim=D, n_classes=4,
                                  kind="noisy_subspace", noise=1.0, seed=0)
    x, y = pairs.make_features(cfg)
    # scaled so that the identity starts near the unit margin
    x = x / np.float32(np.sqrt(2 * 9.0 * D))
    return pairs.sample_pairs(x, y, 1500, 1500, seed=1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close_rel(ours, theirs, rel):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * scale)


def _assert_psd(M, rel=1e-5):
    M = np.asarray(M, np.float64)
    assert np.isfinite(M).all()
    w = np.linalg.eigvalsh(0.5 * (M + M.T))
    assert w.min() >= -rel * max(w.max(), 1e-30)


def test_pgd_step_matches_reference(data):
    # a rank-deficient M0: the step leaves eigenvalues below 0 to clamp
    rng = np.random.RandomState(5)
    A = rng.randn(D, D // 2).astype(np.float32) / np.sqrt(D)
    M0 = (A @ A.T).astype(np.float32)
    sl = slice(0, 200)
    args = [data[k][sl] for k in ("xs", "ys", "sim")]
    kw = dict(lam=1.3, margin=1.0, lr=5.0)
    M, loss = xing2002.pgd_step(_t(M0), *map(_t, args), **kw)
    M_r, loss_r = jax_xing.pgd_step(jnp.asarray(M0),
                                    *map(jnp.asarray, args), **kw)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(M.numpy(), np.asarray(M_r), rtol=1e-5,
                               atol=1e-6)
    w = np.linalg.eigvalsh(np.asarray(M_r, np.float64))
    assert np.sum(np.abs(w) < 1e-5 * w.max()) > 0, "nothing was clamped"


def test_xing_fit_replayed_matches_reference(data):
    cfg = jax_xing.XingConfig(feat_dim=D, lr=5.0, steps=12)
    B = 256
    xs, ys, sim = (jnp.asarray(data[k]) for k in ("xs", "ys", "sim"))
    M_r, losses_r = jax_xing.fit(cfg, xs, ys, sim,
                                 rng=jax.random.PRNGKey(7), batch_size=B)
    # the reference's index sequence, replayed from its split chain
    key, n = jax.random.PRNGKey(7), xs.shape[0]
    M = torch.eye(D, dtype=torch.float32)
    losses = []
    for _ in range(cfg.steps):
        key, sub = jax.random.split(key)
        idx = np.asarray(jax.random.randint(sub, (min(B, n),), 0, n))
        M, loss = xing2002.pgd_step(
            M, *(_t(data[k][idx]) for k in ("xs", "ys", "sim")),
            lam=cfg.lam, margin=cfg.margin, lr=cfg.lr)
        losses.append(float(loss))
    _close_rel(M.numpy(), M_r, 1e-5)
    np.testing.assert_allclose(losses, losses_r, rtol=1e-5)


@pytest.mark.parametrize("gamma", [1e-3, 1.0])
def test_itml_fit_matches_reference(data, gamma):
    # gamma 1e-3 is the paper's; at 1.0 the projections are large enough
    # that the second sweep's alphas meet their lambda bound
    n = 240
    args = [data[k][:n] for k in ("xs", "ys", "sim")]
    cfg = itml.ITMLConfig(feat_dim=D, gamma=gamma, sweeps=2)
    M = itml.fit(cfg, *args, device=CPU)
    M_r = jax_itml.fit(jax_itml.ITMLConfig(feat_dim=D, gamma=gamma,
                                           sweeps=2),
                       *map(jnp.asarray, args))
    assert not np.allclose(np.asarray(M_r), np.eye(D), atol=1e-2)
    _close_rel(M.numpy(), M_r, 1e-4)


@pytest.mark.parametrize("pca_dim", [None, 12])
def test_kiss_fit_matches_reference(data, pca_dim):
    args = [data[k] for k in ("xs", "ys", "sim")]
    M, proj = kiss.fit(kiss.KISSConfig(feat_dim=D, pca_dim=pca_dim,
                                       ridge=1e-6), *args, device=CPU)
    M_r, proj_r = jax_kiss.fit(jax_kiss.KISSConfig(
        feat_dim=D, pca_dim=pca_dim, ridge=1e-6), *map(jnp.asarray, args))
    if pca_dim is None:
        assert proj is None and proj_r is None
        _close_rel(M.numpy(), M_r, 1e-4)
    else:
        assert proj.shape == (D, pca_dim)
        full = (proj @ M @ proj.T).numpy()
        full_r = np.asarray(proj_r @ M_r @ proj_r.T)
        _close_rel(full, full_r, 1e-4)


def test_port_fits_are_psd_and_xing_loss_falls(data):
    args = [data[k] for k in ("xs", "ys", "sim")]
    M_x, losses = xing2002.fit(xing2002.XingConfig(feat_dim=D, lr=5.0,
                                                   steps=30),
                               *args, batch_size=256, device=CPU)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    M_i = itml.fit(itml.ITMLConfig(feat_dim=D, sweeps=1),
                   *(a[:200] for a in args), device=CPU)
    M_k, _ = kiss.fit(kiss.KISSConfig(feat_dim=D, pca_dim=16), *args,
                      device=CPU)
    for M in (M_x, M_i, M_k):
        _assert_psd(M.numpy())
