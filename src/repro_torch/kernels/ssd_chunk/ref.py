"""Plain PyTorch versions of the SSD chunk kernel.

``ssd_scan_ref`` is the port of ``repro/kernels/ssd_chunk/ref.py``: the
exact token-by-token recurrence, kept as the tests' oracle (a Python
loop over T: small inputs only). ``ssd_scan_chunked`` is the chunked
arithmetic (chunks of ``CHUNK`` steps, prefix-summed log decays, the
masked Q x Q decay-weighted scores and the carried (p, n) state),
vectorised over panes: the plain version the card's kernel is held
against, and what ``ops.ssd_core`` runs on the CPU.
``ssd_scan_segmented`` is the card kernel's own order of work: T cut into
segments of whole chunks, each segment's end state from a zero start
(the state pass), the segments' start states combined from those, then
the chunked scan of every segment from its start state (the scan pass).

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


def ssd_scan_chunked(xs, Bm, Cm, dt, la, chunk: int = CHUNK, h0=None,
                     acc=torch.float32):
    """The chunked scan, all in ``acc`` (f32; the card tests' reference
    takes float64), from the state ``h0`` (..., p, n) (zero when None). A
    ragged last chunk is zero-padded, which is exact (zero x, B, C, dt and
    la add nothing and decay nothing). Returns (y (..., T, p) in xs's
    dtype, h_final (..., p, n) in ``acc``)."""
    full_f32()
    T = xs.shape[-2]
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def padded(a, seq_axis):
        a = a.to(acc)
        if not pad:
            return a
        shape = list(a.shape)
        shape[seq_axis] = pad
        return torch.cat([a, a.new_zeros(shape)], dim=seq_axis)

    x, Bf, Cf = padded(xs, -2), padded(Bm, -2), padded(Cm, -2)
    dtf, laf = padded(dt, -1), padded(la, -1)
    lead = torch.broadcast_shapes(x.shape[:-2], Bf.shape[:-2])
    h = torch.zeros(lead + (x.shape[-1], Bf.shape[-1]), dtype=acc,
                    device=xs.device)
    if h0 is not None:
        h = h + h0.to(acc)
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


def ssd_scan_segmented(xs, Bm, Cm, dt, la, chunks_per_segment: int,
                       chunk: int = CHUNK):
    """The scan in the card kernel's order of work, all f32: T cut into S
    segments of ``chunks_per_segment`` chunks (the last one ragged, zero
    padded). State pass: each segment's end state E_s from a zero start
    and its total log decay L_s = sum la. Combine: h_start(0) = 0,
    h_start(s + 1) = exp(L_s) h_start(s) + E_s. Scan pass: the chunked
    scan of every segment from h_start(s); h_final is the last segment's
    end state. Returns (y (..., T, p) in xs's dtype, h_final (..., p, n)
    f32)."""
    full_f32()
    T = xs.shape[-2]
    seg = chunks_per_segment * chunk
    S = -(-T // seg)
    pad = S * seg - T

    def split(a, seq_axis):
        a = a.to(torch.float32)
        if pad:
            shape = list(a.shape)
            shape[seq_axis] = pad
            a = torch.cat([a, a.new_zeros(shape)], dim=seq_axis)
        shape = list(a.shape)
        at = a.dim() + seq_axis
        return a.reshape(shape[:at] + [S, seg] + shape[at + 1:])

    x, Bf, Cf = split(xs, -2), split(Bm, -2), split(Cm, -2)
    dtf, laf = split(dt, -1), split(la, -1)
    _, E = ssd_scan_chunked(x, Bf, Cf, dtf, laf, chunk)     # (..., S, p, n)
    lam = laf.sum(dim=-1)                                   # (..., S)
    starts, h = [], torch.zeros_like(E[..., 0, :, :])
    for s in range(S):
        starts.append(h)
        h = torch.exp(lam[..., s])[..., None, None] * h + E[..., s, :, :]
    y, hs = ssd_scan_chunked(x, Bf, Cf, dtf, laf, chunk,
                             h0=torch.stack(starts, dim=-3))
    y = y.reshape(y.shape[:-3] + (S * seg, y.shape[-1]))[..., :T, :]
    return y.to(xs.dtype), hs[..., -1, :, :]
