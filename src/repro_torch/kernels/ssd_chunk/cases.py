"""The SSD kernel's parity cases on the card: ``chip_smoke.py`` and the
card tests hold ``ssd_scan`` to ``ssd_scan_chunked`` on every one, in
bf16 and f32. Inputs are made by ``inputs`` from a seed.

``PARITY`` (B, H, T, p, n) goes through ``ssd_core`` under the default
``segment_plan``: the CPU tests' shapes, ragged T (1, 100, 1000),
reduced zamba2's p 128 / n 16, 80 heads at p = n = 64, a rank's heads
of zamba2 on a model axis of 16 and of 2 (5, an odd head in a pair's
block, and 40), and p, n of 1 and of 5 / 3 (rows no tensor map
takes).
``PLANNED`` (B, H, T, p, n, chunks_per_segment) forces segments: T one
past, one short of and exactly at segment edges, a last segment of one
partial chunk, 2 to 32 segments, H = 3 (a head pair with one head) and
80, p 8 and 128, n 8 and 64.
``TWO_PLANS``: one input under two plans, whose y must agree within the
f32 bound. Both take ``SLOW`` decay: a state keeps e^-0.26 of itself
over a chunk, so start states from several segments back weigh in.
``STRIDED``: x, B and C as views that no TMA tensor map describes (rows
of 15 and 7 elements at odd offsets), read element by element.
``PER_HEAD``: B and C with a head stride of their own (one head a
block).
``GROWING``: la > 0 (la = +0.05 dt), so exp(W_t - W_s) exceeds 1 below
the diagonal, over three segments.

``SSD_TOL`` is the bound of y and h against the plain version in f32
(PARITY, through ``ssd_core``) or against ``reference`` in float64 (the
pane-layout cases): rtol = atol = 1e-4 for f32 inputs, the reference's
bound for its kernel against its oracle. bf16 inputs: the kernel
computes in f32 and rounds y to bf16 once (at most ``BF16_ROUND`` |y|),
so y may differ by 2^-8 |ref| on top of the f32 rtol and an atol of 1e-5
(the f32 error near y = 0); the f32 state h meets the f32 bound.
"""

import numpy as np
import torch

from repro_torch.kernels.ssd_chunk.ref import ssd_scan_chunked

PARITY = [(1, 4, 64, 16, 8), (1, 2, 128, 64, 64), (1, 8, 96, 32, 16),
          (1, 1, 256, 64, 64), (1, 3, 32, 8, 8), (2, 4, 100, 128, 16),
          (2, 80, 200, 64, 64), (1, 2, 1, 64, 64), (2, 4, 128, 128, 16),
          (2, 80, 1000, 64, 64), (1, 3, 130, 1, 1), (1, 2, 70, 5, 3),
          (1, 5, 4096, 64, 64), (2, 40, 1000, 64, 64)]

PLANNED = [(1, 3, 64 * 4 * 3 + 1, 8, 8, 4), (1, 3, 64 * 4 * 2 - 1, 64, 64, 4),
           (2, 80, 64 * 8 * 2, 64, 64, 8), (1, 5, 1000, 128, 64, 2),
           (1, 3, 64 * 3 * 3 + 10, 128, 8, 3), (2, 4, 2048, 64, 64, 1),
           (1, 2, 64 * 2 + 64, 64, 64, 2)]

TWO_PLANS = (1, 4, 1500, 64, 64, (2, 5))
SLOW = 0.05         # la = -SLOW dt, dt ~ 0.08: e^-0.26 over a chunk
STRIDED = (1, 3, 300, 15, 7)
PER_HEAD = (1, 3, 300, 32, 16)
GROWING = (1, 3, 300, 32, 16, 2)
GROW = -0.05        # la = +0.05 dt

BF16_ROUND = 2.0 ** -8
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=1e-4 + BF16_ROUND, atol=1e-5)}


def inputs(B, H, T, p, n, dtype, device, seed, decay=5.0):
    """Model-layout SSD inputs: xs (B, T, H, p), Bm / Cm (B, T, n) in
    ``dtype``, dt (B, T, H) = 0.1 |N(0, 1)| and la = -decay dt, f32."""
    rng = np.random.RandomState(seed)

    def f(*s):
        return torch.tensor(rng.randn(*s), dtype=torch.float32, device=device)
    xs, Bm, Cm = f(B, T, H, p).to(dtype), f(B, T, n).to(dtype), \
        f(B, T, n).to(dtype)
    dt = f(B, T, H).abs() * 0.1
    return xs, Bm, Cm, dt, -decay * dt


def panes(xs, Bm, Cm, dt, la):
    """``inputs`` as the kernel's (B, H, T, ...) views, B and C expanded
    over the heads with a head stride of 0."""
    B, T, H, _ = xs.shape
    n = Bm.shape[-1]
    return (xs.transpose(1, 2), Bm[:, None].expand(B, H, T, n),
            Cm[:, None].expand(B, H, T, n), dt.transpose(1, 2),
            la.transpose(1, 2))


def strided(dtype, device, seed=5):
    """``STRIDED``'s inputs in the kernel's pane layout: x a view into
    (B, T, H, p + 1) from column 1, B and C views into one (B, T, 2 n + 1)
    tensor from columns 1 and n + 1."""
    B, H, T, p, n = STRIDED
    rng = np.random.RandomState(seed)
    big = torch.tensor(rng.randn(B, T, H, p + 1), dtype=torch.float32,
                       device=device).to(dtype)
    bc = torch.tensor(rng.randn(B, T, 2 * n + 1), dtype=torch.float32,
                      device=device).to(dtype)
    dt = torch.tensor(np.abs(rng.randn(B, T, H)) * 0.1, dtype=torch.float32,
                      device=device)
    return panes(big[..., 1:], bc[..., 1:n + 1], bc[..., n + 1:], dt,
                 -5.0 * dt)


def per_head(dtype, device, seed=7):
    """``PER_HEAD``'s inputs in the pane layout, B and C (B, H, T, n)
    contiguous: a head stride of n."""
    B, H, T, p, n = PER_HEAD
    xs, _, _, dt, la = inputs(B, H, T, p, n, dtype, device, seed)
    rng = np.random.RandomState(seed + 1)
    Bh, Ch = (torch.tensor(rng.randn(B, H, T, n), dtype=torch.float32,
                           device=device).to(dtype) for _ in range(2))
    return xs.transpose(1, 2), Bh, Ch, dt.transpose(1, 2), la.transpose(1, 2)


def reference(xs, Bm, Cm, dt, la):
    """The pane-layout cases' reference: ``ssd_scan_chunked`` in float64
    on the same values; returns (y, h) in float64."""
    return ssd_scan_chunked(xs.double(), Bm.double(), Cm.double(), dt, la,
                            acc=torch.float64)
