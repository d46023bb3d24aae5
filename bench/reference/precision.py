"""The precisions the reference computes in.

``f64``: every product and sum in float64, the yardstick. ``f32``: float32
with TF32 off. ``tf32``: the control, one step below the configurations'
float32: each product's operands rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and summed in
float32, as TF32 tensor cores do, on any device.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f64", "f32", "tf32")


def dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 by bit masking (finite inputs)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | (bits & ~0x7FFFFFFF)).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in ``precision`` (inputs cast to its dtype first)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = dtype(precision)
    a, b = a.to(dt), b.to(dt)
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return a @ b
