"""Baseline: the original DML formulation of Xing et al. (2002), Eq. 1
(counterpart of ``repro/core/xing2002.py``).

Solved with projected gradient ascent/descent:
  * gradient step on  sum_S (x-y)^T M (x-y)  minus a penalty pushing
    dissimilar pairs beyond the unit margin,
  * projection of M onto the PSD cone via eigendecomposition (the O(d^3)
    step whose removal motivates the paper's reformulation).

This is the comparison method labeled "Xing2002" in Fig. 4. It is kept
single-device on purpose — the paper's point is that this form does not
distribute. The gradient comes from autograd; ``fit`` draws each
minibatch's indices on the device with ``torch.randint`` (with
replacement, as the reference's ``jax.random.randint``, whose stream the
port cannot reproduce).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import dml
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class XingConfig:
    feat_dim: int
    lr: float = 1e-2
    margin: float = 1.0
    lam: float = 1.0          # weight on the dissimilarity hinge penalty
    steps: int = 100


def _penalized_objective(M, xs, ys, sim, lam, margin):
    """Eq. 1 with the hard constraint softened to a hinge (for PGD).

    The PSD constraint is handled by projection, not by the objective.
    """
    d2 = dml.mahalanobis_sqdist_M(M, xs, ys)
    sim_f = sim.to(d2.dtype)
    hinge = torch.clamp_min(margin - d2, 0.0)
    return torch.mean(sim_f * d2 + (1.0 - sim_f) * lam * hinge)


def pgd_step(M, xs, ys, sim, *, lam: float, margin: float, lr: float):
    """One projected-gradient step: gradient descent then PSD projection.
    Returns (M, loss) with the loss a 0-d tensor."""
    with torch.enable_grad():
        Mv = M.detach().requires_grad_(True)
        loss = _penalized_objective(Mv, xs, ys, sim, lam, margin)
        (g,) = torch.autograd.grad(loss, Mv)
    M = M - lr * g
    M = dml.psd_project(M)    # O(d^3) eigendecomposition every step
    return M, loss.detach()


def fit(cfg: XingConfig, xs, ys, sim,
        generator: Optional[torch.Generator] = None, batch_size: int = 1000,
        device=None):
    """Full-batch-less PGD training loop over minibatches (host loop).
    ``generator`` draws the batch indices and lives on the run's device
    (default: one seeded 0). Returns (M, per-step losses)."""
    dev = resolve_device(device)
    xs, ys, sim = (torch.as_tensor(a).to(dev) for a in (xs, ys, sim))
    M = torch.eye(cfg.feat_dim, dtype=torch.float32, device=dev)
    n = xs.shape[0]
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    losses = []
    for _ in range(cfg.steps):
        idx = torch.randint(0, n, (min(batch_size, n),), generator=gen,
                            device=dev)
        M, loss = pgd_step(M, xs[idx], ys[idx], sim[idx],
                           lam=cfg.lam, margin=cfg.margin, lr=cfg.lr)
        losses.append(float(loss))
    return M, losses
