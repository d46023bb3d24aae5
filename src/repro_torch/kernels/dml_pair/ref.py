"""Plain PyTorch version of the fused DML pair kernel (paper Eq. 4)."""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import full_f32


def dml_pair_ref(L, xs, ys, sim, lam: float = 1.0, margin: float = 1.0):
    """Returns (losses (B,), sqdists (B,), proj (B, k)).

    losses[b] = sim_b * d2_b + (1-sim_b) * lam * max(0, margin - d2_b)
    where d2_b = ||L (xs_b - ys_b)||^2 computed in f32.
    """
    full_f32()
    z = (xs - ys).to(torch.float32)
    proj = z @ L.to(torch.float32).T                    # (B, k)
    d2 = torch.sum(torch.square(proj), dim=-1)          # (B,)
    simf = sim.to(torch.float32)
    hinge = torch.clamp_min(margin - d2, 0.0)
    losses = simf * d2 + (1.0 - simf) * lam * hinge
    return losses, d2, proj
