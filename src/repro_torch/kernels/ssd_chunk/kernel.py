"""ctypes wrapper of the hand-written Hopper kernel ``csrc/ssd_chunk.cu``.

Counterpart of ``repro/kernels/ssd_chunk/kernel.py::ssd_scan``: the
Mamba2 SSD scan over B x H panes, f32 arithmetic on bf16 or f32 x, B, C,
any T (the kernel zero-fills a ragged last chunk), p <= 128, n <= 64.
Inputs are read through their strides: a (B, H, T, p) view of the
model's (B, T, H, p) activations, B and C expanded over heads with a
head stride of 0. The kernel is forward-only, as the TPU kernel is: an
input that requires grad raises. The library is built on first use
(``kernels/_build.py``); nothing here touches CUDA at import time. The
wrapper checks its inputs before it builds or launches anything,
allocates the outputs with ``torch.empty``, launches on the current
stream without synchronising, raises on a non-zero ``cudaError_t``, and
counts its launches in ``ssd_scan.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
MAX_P, MAX_N = 128, 64

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 5 + [ll] * 18 + [i, p]
        lib.ssd_scan_launch.restype = i
        for name in ("length", "max_p", "max_n"):
            getattr(lib, f"ssd_chunk_{name}").restype = i
        if (lib.ssd_chunk_length(), lib.ssd_chunk_max_p(),
                lib.ssd_chunk_max_n()) != (CHUNK, MAX_P, MAX_N):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"chunk or tile sizes")
        _lib = lib
    return _lib


def _check(name, x, dtype, ndim, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel is forward-only")


def ssd_scan(xs: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, la: torch.Tensor):
    """The SSD scan on the card over B x H panes: xs (B,H,T,p), Bm/Cm
    (B,H,T,n), dt/la (B,H,T); any strides, the last axis of xs, Bm and
    Cm contiguous; xs, Bm and Cm bf16 or f32 alike, dt and la f32.
    Returns (y (B,H,T,p) in xs's dtype, h_final (B,H,p,n) f32). y is a
    view of (B,T,H,p) memory, so ``y.transpose(1, 2)`` is the model's
    contiguous layout."""
    device = xs.device
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA tensors, got {device}")
    if xs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"xs must be bfloat16 or float32, got {xs.dtype}")
    _check("xs", xs, xs.dtype, 4, device)
    for name, x in (("Bm", Bm), ("Cm", Cm)):
        _check(name, x, xs.dtype, 4, device)
    for name, x in (("dt", dt), ("la", la)):
        _check(name, x, torch.float32, 3, device)
    B, H, T, p = xs.shape
    n = Bm.shape[-1]
    if tuple(Bm.shape) != (B, H, T, n) or tuple(Cm.shape) != (B, H, T, n) \
            or tuple(dt.shape) != (B, H, T) or tuple(la.shape) != (B, H, T):
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, dt "
                         f"{tuple(dt.shape)}, la {tuple(la.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"p={p}, n={n}: the kernel takes p <= {MAX_P}, "
                         f"n <= {MAX_N}")
    for name, x in (("xs", xs), ("Bm", Bm), ("Cm", Cm)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    y = torch.empty((B, T, H, p), dtype=xs.dtype,
                    device=device).transpose(1, 2)
    hf = torch.empty((B, H, p, n), dtype=torch.float32, device=device)
    if B * H == 0 or T == 0:
        return y, hf.zero_()
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    strides = [s for x in (xs, Bm, Cm, dt, la, y) for s in x.stride()[:3]]
    with torch.cuda.device(device):
        err = lib.ssd_scan_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (xs, Bm, Cm, dt, la, y,
                                                       hf)),
            B, H, T, p, n, *strides, int(xs.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t "
                           f"{err}")
    ssd_scan.launches += 1
    return y, hf


ssd_scan.launches = 0
