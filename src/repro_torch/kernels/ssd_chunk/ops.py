"""Wrapper: run a Mamba2 layer's SSD core through the SSD kernel
(counterpart of ``repro/kernels/ssd_chunk/ops.py``).

The inference / prefill path: forward-only, as the reference's. The
model's (B, T, H, ...) activations go to the kernel as strided
(B, H, T, ...) views and B, C as views expanded over heads with a head
stride of 0: no transpose and no per-head copy (the reference
broadcasts B and C to every head). Dispatch goes by device, with no
knob and no fallback: the hand-written kernel on CUDA tensors (any T:
the kernel zero-fills a ragged last chunk, where the reference's wrapper
quietly took its oracle), the plain chunked version on CPU tensors.
"""

from __future__ import annotations

from repro_torch.kernels.ssd_chunk.kernel import ssd_scan
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_chunked


def ssd_core(xs, Bm, Cm, dt, la):
    """xs (B,T,H,p); Bm/Cm (B,T,n) shared across heads (mamba2
    ngroups=1); dt/la (B,T,H) f32. Returns (y (B,T,H,p), h_final
    (B,H,p,n) f32)."""
    B, T, H, p = xs.shape
    n = Bm.shape[-1]
    xs_p = xs.transpose(1, 2)                   # (B,H,T,p) views
    dt_p, la_p = dt.transpose(1, 2), la.transpose(1, 2)
    if xs.is_cuda:
        y, hf = ssd_scan(xs_p, Bm[:, None].expand(B, H, T, n),
                         Cm[:, None].expand(B, H, T, n), dt_p, la_p)
    else:
        y, hf = ssd_scan_chunked(xs_p, Bm[:, None], Cm[:, None], dt_p, la_p)
    return y.transpose(1, 2).contiguous(), hf     # a no-op for the kernel's y
