"""Baseline: Information-Theoretic Metric Learning (Davis et al., 2007),
counterpart of ``repro/core/itml.py``.

ITML minimizes the LogDet divergence to a prior metric M0 subject to
distance constraints, solved with Bregman projections — one (cheap, rank-one)
projection per constraint visit:

  similar (x,y):      d_M(x,y) <= u
  dissimilar (x,y):   d_M(x,y) >= l

Update (for a visited constraint with z = x - y):
  p     = z^T M z
  alpha = min(lambda_i, gamma/(gamma+1) * (1/p - 1/target))
  beta  = delta * alpha / (1 - delta * alpha * p)       (delta = +1 sim, -1 dis)
  M    <- M + beta * (M z)(M z)^T

This is the paper's Fig. 4 comparison; per-pair cost is O(d^2), vs O(dk)
for the reformulated method — exactly the gap the paper highlights.

The reference's ``lax.scan`` over the constraints is a sequential sweep on
the device here. Every per-constraint quantity stays a tensor, so a sweep
issues its small launches without a host sync; it is bound by launches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import full_f32


@dataclasses.dataclass(frozen=True)
class ITMLConfig:
    feat_dim: int
    gamma: float = 1e-3       # slack tradeoff (paper §5.4 uses 0.001)
    u: float = 1.0            # upper bound for similar-pair distances
    l: float = 4.0            # lower bound for dissimilar-pair distances
    sweeps: int = 3           # passes over the constraint set


def fit(cfg: ITMLConfig, xs, ys, sim, device=None):
    """Run ITML Bregman projections: ``cfg.sweeps`` sequential sweeps over
    the constraints on ``device`` (the card by default). Returns M."""
    dev = resolve_device(device)
    full_f32()
    xs, ys, sim = (torch.as_tensor(a).to(dev) for a in (xs, ys, sim))
    n, d = xs.shape
    z_all = (xs - ys).to(torch.float32)                    # (n, d)
    delta_all = torch.where(sim > 0, 1.0, -1.0)            # (n,)
    target_all = torch.where(sim > 0, cfg.u, cfg.l)        # (n,)
    # per-constraint factors of alpha, computed once in the reference's
    # order: delta * (gamma / (gamma + 1)) and 1 / target
    coef_all = delta_all * (cfg.gamma / (cfg.gamma + 1.0))
    inv_target_all = 1.0 / target_all

    M = torch.eye(d, dtype=torch.float32, device=dev)
    lambdas = torch.zeros((n,), dtype=torch.float32, device=dev)
    for _ in range(cfg.sweeps):
        for i in range(n):
            z, delta = z_all[i], delta_all[i]
            Mz = M @ z                                     # (d,)
            p = torch.clamp_min(z @ Mz, 1e-12)
            alpha = torch.minimum(lambdas[i],
                                  coef_all[i] * (1.0 / p - inv_target_all[i]))
            beta = delta * alpha / (1.0 - delta * alpha * p)
            M = M + beta * torch.outer(Mz, Mz)
            lambdas[i] -= alpha
    return M
