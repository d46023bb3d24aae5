"""Baseline: KISS metric learning (Koestinger et al., CVPR 2012),
counterpart of ``repro/core/kiss.py``.

"Keep It Simple and Straightforward": a one-shot, likelihood-ratio-test
metric with no iterative optimization —

  M = Sigma_S^{-1} - Sigma_D^{-1}

where Sigma_S / Sigma_D are covariance matrices of pairwise differences over
similar / dissimilar pairs. The result is projected onto the PSD cone to make
it a valid metric (as in the original paper's practical recipe). Optionally a
PCA pre-projection keeps the covariances invertible (the paper reduces MNIST
to 600 dims before KISS). The PCA axes are eigenvectors, each defined only
up to its sign, so two runs agree on ``proj M projᵀ``, not on M.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import dml
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import full_f32


@dataclasses.dataclass(frozen=True)
class KISSConfig:
    feat_dim: int
    pca_dim: Optional[int] = None   # reduce before covariance estimation
    ridge: float = 1e-6             # diagonal loading for invertibility


def pca_basis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Top-`dim` principal axes of x (n, d) -> (d, dim)."""
    full_f32()
    xc = x - torch.mean(x, dim=0, keepdim=True)
    # economical SVD: eigh on the d x d covariance
    cov = xc.T @ xc / x.shape[0]
    w, V = torch.linalg.eigh(cov)
    return V[:, -dim:]              # ascending eigenvalues -> take last `dim`


def _kiss_metric(zs_sim: torch.Tensor, zs_dis: torch.Tensor,
                 ridge: float) -> torch.Tensor:
    full_f32()
    d = zs_sim.shape[1]
    eye = torch.eye(d, dtype=torch.float32, device=zs_sim.device)
    cov_s = zs_sim.T @ zs_sim / zs_sim.shape[0] + ridge * eye
    cov_d = zs_dis.T @ zs_dis / zs_dis.shape[0] + ridge * eye
    M = torch.linalg.inv(cov_s) - torch.linalg.inv(cov_d)
    return dml.psd_project(M)


def fit(cfg: KISSConfig, xs, ys, sim, device=None):
    """Returns (M, projection) — apply `x @ projection` before using M if
    not None. Runs on ``device`` (the card by default)."""
    dev = resolve_device(device)
    xs, ys, sim = (torch.as_tensor(a).to(dev) for a in (xs, ys, sim))
    proj = None
    if cfg.pca_dim is not None and cfg.pca_dim < cfg.feat_dim:
        allx = torch.cat([xs, ys], dim=0)
        proj = pca_basis(allx, cfg.pca_dim)
        xs, ys = xs @ proj, ys @ proj
    z = xs - ys
    zs_sim = z[sim > 0]
    zs_dis = z[sim <= 0]
    M = _kiss_metric(zs_sim, zs_dis, cfg.ridge)
    return M, proj
