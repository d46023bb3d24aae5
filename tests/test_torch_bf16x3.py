"""The bf16 SSD kernel's products, modelled on the CPU.

For bf16 inputs ``ssd_chunk.cu`` runs every product of the chunked scan
on bf16 tensor-core products (wgmma k16) with f32 accumulation. One side
of each product is exact in bf16: C in h C^T, x in x^T att^T, B in
(x o src)^T B, both sides in C B^T. The f32 side (the state h, att,
x o src) goes in as three bf16 pieces p0 + p1 + p2 (the kernel's
``split3``): p0 the value rounded to bf16 (to nearest, ties away from
zero), p1 and p2 the top 8 significant bits of what the pieces before
them left. A piece times an exact bf16 value is exact in f32, so the
only rounding beyond f32 accumulation is what the three pieces leave,
below 2^-23 |x| (2xTF32 leaves up to 2^-22).

Here that arithmetic runs in plain torch over the scan at zamba2's
service widths (p = n = 64, chunks of 64, 2048 tokens) and is held to the
f32 chunked scan (``ssd_scan_chunked``) within the card's f32 bound
(rtol = atol = 1e-4). What a split loses is measured apart from f32
rounding, by running the same model in float64 with and without the
split: the three bf16 pieces lose less than the 2xTF32 split the design
first named (hi and lo of the f32 side, round to nearest). As a negative
control, one bf16 piece (p0 alone) must fail the bound.

The model cannot show the tensor cores' own accumulation, which the
kernel promotes into an f32 sum every chunk; the card's parity checks
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) hold the kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels._dispatch import full_f32, tf32_split
from repro_torch.kernels.ssd_chunk import ssd_scan_chunked

Q = 64


def _rn_bf16(x):
    """f32 rounded to bf16 (to nearest, ties away from zero) by adding half
    of the dropped 16 bits to the magnitude and clearing them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x8000) & -65536).view(torch.float32)


def _trunc_bf16(x):
    """The top 8 significant bits of f32 values (low 16 bits cleared)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def bf16x3_split(x):
    """The kernel's split3: three bf16 pieces of f32 ``x``."""
    x = x.to(torch.float32)
    p0 = _rn_bf16(x)
    r = x - p0
    p1 = _trunc_bf16(r)
    return p0, p1, _trunc_bf16(r - p1)


def _pieces(x, split):
    if split == "none":
        return (x.to(torch.float32),)
    if split == "bf16x3":
        return bf16x3_split(x)
    if split == "tf32x2":
        return tf32_split(x)
    if split == "bf16x1":
        return (_rn_bf16(x.to(torch.float32)),)
    raise ValueError(split)


def _prod(exact, f32, split, f32_first):
    """exact @ f32 (f32_first: f32 @ exact) with ``f32``, rounded to f32,
    in pieces; each piece's product is exact in f32 and summed in the
    operands' dtype."""
    out = 0
    for part in _pieces(f32, split):
        part = part.to(exact.dtype)
        out = out + (part @ exact if f32_first else exact @ part)
    return out


def _scan_model(xs, Bm, Cm, dt, la, split, dtype=torch.float32):
    """The chunked scan with the kernel's four products in ``split``
    arithmetic (x, B, C exact in bf16), the rest in ``dtype``. Pane
    layout, T a multiple of Q."""
    full_f32()
    xs, Bm, Cm, dt, la = (a.to(dtype) for a in (xs, Bm, Cm, dt, la))
    T = xs.shape[-2]
    h = torch.zeros(xs.shape[:-2] + (xs.shape[-1], Bm.shape[-1]),
                    dtype=dtype)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    ys = []
    for c in range(T // Q):
        sl = slice(c * Q, (c + 1) * Q)
        x, B, C = xs[..., sl, :], Bm[..., sl, :], Cm[..., sl, :]
        W = torch.cumsum(la[..., sl], -1)
        G = C @ B.transpose(-1, -2)                       # exact products
        decay = torch.exp(W[..., :, None] - W[..., None, :])
        att = torch.where(tril, G * decay, torch.zeros_like(decay)) \
            * dt[..., None, sl]
        y_inter = _prod(C, h.transpose(-1, -2), split, False) \
            * torch.exp(W)[..., None]
        ys.append(y_inter + _prod(x, att, split, True))
        src = dt[..., sl] * torch.exp(W[..., -1:] - W)
        ds = _prod(B, (x * src[..., None]).transpose(-1, -2), split, True)
        h = torch.exp(W[..., -1:])[..., None] * h + ds
    return torch.cat(ys, -2), h


def _inputs(seed, T=2048, p=64, n=64, panes=2):
    rng = np.random.RandomState(seed)

    def bf16(*s):      # values exact in bf16, as the kernel's inputs are
        return torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
            torch.bfloat16).to(torch.float32)
    xs, Bm, Cm = bf16(panes, T, p), bf16(panes, T, n), bf16(panes, T, n)
    dt = torch.from_numpy((np.abs(rng.randn(panes, T)) * 0.05)
                          .astype(np.float32))
    la = -dt * torch.from_numpy(rng.uniform(0.05, 2.0, (panes, 1))
                                .astype(np.float32))
    return xs, Bm, Cm, dt, la


@pytest.mark.parametrize("seed", range(3))
def test_pieces_are_bf16_and_sum_back(seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(4096).astype(
        np.float32) * 10.0 ** np.random.RandomState(seed + 7).uniform(
        -20, 20, 4096).astype(np.float32))
    parts = bf16x3_split(x)
    for part in parts:
        assert not bool((part.view(torch.int32) & 0xFFFF).any())
    left = (x.double() - sum(part.double() for part in parts)).abs()
    assert bool((left <= 2.0 ** -23 * x.double().abs()).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16x3_scan_within_the_f32_bound(seed):
    args = _inputs(seed)
    y, h = _scan_model(*args, "bf16x3")
    yr, hr = ssd_scan_chunked(*args)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16x3_loses_less_than_tf32x2(seed):
    """What each split loses, apart from f32 rounding: the model in
    float64 with the split against the model in float64 without it."""
    args = _inputs(seed)
    ye, he = _scan_model(*args, "none", torch.float64)
    lost = {}
    for split in ("bf16x3", "tf32x2"):
        y, h = _scan_model(*args, split, torch.float64)
        lost[split] = (float((y - ye).abs().max() / ye.abs().max()),
                       float((h - he).abs().max() / he.abs().max()))
    assert lost["bf16x3"][0] < lost["tf32x2"][0] < 1e-6
    assert lost["bf16x3"][1] < lost["tf32x2"][1] < 1e-6


def test_one_bf16_piece_fails_the_bound():
    args = _inputs(0)
    y, _ = _scan_model(*args, "bf16x1")
    yr, _ = ssd_scan_chunked(*args)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=1e-4,
                                   atol=1e-4)
