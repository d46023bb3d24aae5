"""Public wrapper for the fused DML pair kernel, with its closed-form
backward (counterpart of ``repro/kernels/dml_pair/ops.py``).

Forward: dispatch by device, no knob and no fallback. A CUDA tensor goes
to the hand-written kernel (kernel.py), a CPU tensor to the plain
version (ref.py). Backward: the closed-form gradients on the saved
projection, two full-f32 ``torch.matmul`` products as the reference
leaves them to XLA (no kernel):

    w_b    = sim_b - lam * (1 - sim_b) * 1{d2_b < margin}   (hinge weight)
    dL     = 2/B * (proj * w)^T @ z * g
    dz     = 2/B * w * (proj @ L) * g ;  dxs = dz, dys = -dz
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import full_f32
from repro_torch.kernels.dml_pair.kernel import dml_pair_fused
from repro_torch.kernels.dml_pair.ref import dml_pair_ref


def dml_pair_forward(L, xs, ys, sim, lam: float = 1.0, margin: float = 1.0):
    """(losses, d2, proj): the kernel on CUDA tensors, the plain version
    on CPU tensors. The kernel takes f32 only and raises on anything
    else."""
    if not xs.is_cuda:
        return dml_pair_ref(L, xs, ys, sim, lam, margin)
    return dml_pair_fused(L.contiguous(), xs.contiguous(), ys.contiguous(),
                          sim, lam=lam, margin=margin)


class _DMLPairLoss(torch.autograd.Function):
    """Mean Eq. 4 loss and the per-pair d2 (not differentiable)."""

    @staticmethod
    def forward(ctx, L, xs, ys, sim, lam, margin):
        losses, d2, proj = dml_pair_forward(L, xs, ys, sim, lam, margin)
        ctx.save_for_backward(L, xs, ys, sim, d2, proj)
        ctx.lam, ctx.margin = lam, margin
        ctx.mark_non_differentiable(d2)
        return torch.mean(losses), d2

    @staticmethod
    def backward(ctx, g, _g_d2):
        L, xs, ys, sim, d2, proj = ctx.saved_tensors
        full_f32()
        B = xs.shape[0]
        simf = sim.to(torch.float32)
        active = (d2 < ctx.margin).to(torch.float32)
        w = simf - ctx.lam * (1.0 - simf) * active            # (B,)
        pw = proj * w[:, None]                                 # (B, k)
        scale = 2.0 * g / B
        dL = dxs = dys = None
        if ctx.needs_input_grad[0]:
            z = (xs - ys).to(torch.float32)
            dL = ((scale * pw.T) @ z).to(L.dtype)              # (k, d)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dz = scale * (pw @ L.to(torch.float32))            # (B, d)
            dxs, dys = dz.to(xs.dtype), (-dz).to(ys.dtype)
        return dL, dxs, dys, None, None, None


def dml_pair_loss_and_d2(L, xs, ys, sim, lam: float = 1.0,
                         margin: float = 1.0):
    """Mean Eq. 4 objective (differentiable w.r.t. L, xs, ys) and the
    forward's per-pair squared distances d2 (B,)."""
    return _DMLPairLoss.apply(L, xs, ys, sim, float(lam), float(margin))


def dml_pair_loss_fused(L, xs, ys, sim, lam: float = 1.0,
                        margin: float = 1.0):
    """Mean Eq. 4 objective through the kernel (on CUDA) with the
    closed-form backward. Differentiable w.r.t. L, xs, ys (the latter two
    enable end-to-end deep metric learning)."""
    return dml_pair_loss_and_d2(L, xs, ys, sim, lam, margin)[0]


def dml_pair_loss_reference(L, xs, ys, sim, lam: float = 1.0,
                            margin: float = 1.0):
    """Oracle mean objective (plain PyTorch, autograd through it)."""
    losses, _, _ = dml_pair_ref(L, xs, ys, sim, lam, margin)
    return torch.mean(losses)
