"""Plain PyTorch version of the tiled pairwise-distance kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import full_f32


def pairwise_sqdist_ref(xp, yp, yn=None):
    """xp (N,k), yp (M,k) projected points (L @ x). Returns (N,M) f32:
    D[i,j] = ||xp_i - yp_j||^2. ``yn`` optionally supplies precomputed
    ||yp||^2 row norms (the retrieval index amortizes them)."""
    full_f32()
    xp = xp.to(torch.float32)
    yp = yp.to(torch.float32)
    xn = torch.sum(torch.square(xp), dim=1)
    if yn is None:
        yn = torch.sum(torch.square(yp), dim=1)
    cross = xp @ yp.T
    return torch.clamp_min(xn[:, None] + yn.to(torch.float32)[None, :]
                           - 2.0 * cross, 0.0)
