"""Plain PyTorch versions of the SSD chunk kernel.

``ssd_scan_ref`` is the port of ``repro/kernels/ssd_chunk/ref.py``: the
exact token-by-token recurrence, kept as the tests' oracle (a Python
loop over T: small inputs only). ``ssd_scan_chunked`` is the kernel's own
arithmetic (chunks of ``CHUNK`` steps, prefix-summed log decays, the
masked Q x Q decay-weighted scores and the carried (p, n) state),
vectorised over panes: the plain version the card's kernel is held
against, and what ``ops.ssd_core`` runs on the CPU.

Both take the pane layout with any leading pane axes: xs (..., T, p),
Bm / Cm (..., T, n), dt / la (..., T); Bm / Cm may broadcast over the
pane axes (Mamba2 shares them across heads).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import full_f32

CHUNK = 64          # the CUDA kernel's chunk length (csrc/ssd_chunk.cu)


def ssd_scan_ref(xs, Bm, Cm, dt, la):
    """Exact recurrence. h_t = exp(la_t) h_{t-1} + dt_t x_t B_t^T ;
    y_t = h_t C_t. Returns (y (..., T, p) in xs's dtype, h_final
    (..., p, n) f32)."""
    full_f32()
    x = xs.to(torch.float32)
    Bf, Cf = Bm.to(torch.float32), Cm.to(torch.float32)
    dtf, laf = dt.to(torch.float32), la.to(torch.float32)
    lead = torch.broadcast_shapes(x.shape[:-2], Bf.shape[:-2])
    h = torch.zeros(lead + (x.shape[-1], Bf.shape[-1]), dtype=torch.float32,
                    device=xs.device)
    ys = []
    for t in range(x.shape[-2]):
        h = (torch.exp(laf[..., t])[..., None, None] * h
             + dtf[..., t, None, None] * (x[..., t, :, None]
                                          * Bf[..., t, None, :]))
        ys.append(h @ Cf[..., t, :, None])
    y = torch.cat(ys, dim=-1).transpose(-1, -2)
    return y.to(xs.dtype), h


def ssd_scan_chunked(xs, Bm, Cm, dt, la, chunk: int = CHUNK):
    """The chunked scan in the kernel's arithmetic, all f32. A ragged last
    chunk is zero-padded, which is exact (zero x, B, C, dt and la add
    nothing and decay nothing). Returns (y (..., T, p) in xs's dtype,
    h_final (..., p, n) f32)."""
    full_f32()
    T = xs.shape[-2]
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def padded(a, seq_axis):
        a = a.to(torch.float32)
        if not pad:
            return a
        shape = list(a.shape)
        shape[seq_axis] = pad
        return torch.cat([a, a.new_zeros(shape)], dim=seq_axis)

    x, Bf, Cf = padded(xs, -2), padded(Bm, -2), padded(Cm, -2)
    dtf, laf = padded(dt, -1), padded(la, -1)
    lead = torch.broadcast_shapes(x.shape[:-2], Bf.shape[:-2])
    h = torch.zeros(lead + (x.shape[-1], Bf.shape[-1]), dtype=torch.float32,
                    device=xs.device)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xs.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        x_c, B_c, C_c = x[..., sl, :], Bf[..., sl, :], Cf[..., sl, :]
        dt_c, la_c = dtf[..., sl], laf[..., sl]
        W = torch.cumsum(la_c, dim=-1)                      # (..., Q)
        W_last = W[..., -1:]
        y_inter = (C_c @ h.transpose(-1, -2)) * torch.exp(W)[..., None]
        G = C_c @ B_c.transpose(-1, -2)                     # (..., Q, Q)
        decay = torch.exp(W[..., :, None] - W[..., None, :])
        # select, never multiply by the mask: decay is inf above the diagonal
        att = torch.where(tril, G * decay, torch.zeros_like(decay)) \
            * dt_c[..., None, :]
        ys.append(y_inter + att @ x_c)
        src = dt_c * torch.exp(W_last - W)
        h = (torch.exp(W_last)[..., None] * h
             + (x_c * src[..., None]).transpose(-1, -2) @ B_c)
    y = torch.cat(ys, dim=-2)[..., :T, :]
    return y.to(xs.dtype), h
