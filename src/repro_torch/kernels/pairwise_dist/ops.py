"""Public wrapper for the pairwise-distance kernel (counterpart of
``repro/kernels/pairwise_dist/ops.py``).

The projection through L stays a full-f32 ``torch.matmul`` (the
reference does it outside its kernel too); the all-pairs distances then
go by device, with no knob and no fallback: the hand-written kernel on
CUDA tensors (any shape), the plain version (ref.py) on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import full_f32
from repro_torch.kernels.pairwise_dist.kernel import pairwise_sqdist
from repro_torch.kernels.pairwise_dist.ref import pairwise_sqdist_ref


def pairwise_sqdist_any(xp, yp):
    """All-pairs squared distances of projected points: the kernel on the
    card, the plain version on the CPU."""
    if not xp.is_cuda:
        return pairwise_sqdist_ref(xp, yp)
    return pairwise_sqdist(xp.to(torch.float32).contiguous(),
                           yp.to(torch.float32).contiguous())


def metric_sqdist_matrix(L, x, y):
    """All-pairs Mahalanobis distances: D[i,j] = ||L(x_i - y_j)||^2.

    Projects through L first (O((N+M) k d)), then runs the tiled kernel on
    the much smaller k-dimensional cross term.
    """
    full_f32()
    Lf = L.to(torch.float32)
    xp = x.to(torch.float32) @ Lf.T
    yp = y.to(torch.float32) @ Lf.T
    return pairwise_sqdist_any(xp, yp)
