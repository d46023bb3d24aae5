"""ctypes wrapper of the hand-written Hopper kernel ``csrc/dml_pair.cu``.

Counterpart of ``repro/kernels/dml_pair/kernel.py::dml_pair_fused``: the
fused Eq. 4 forward, returning ``(losses, d2, proj)``. The library is
built on first use (``kernels/_build.py``); nothing here touches CUDA at
import time. The wrapper checks its inputs before it builds or launches
anything, casts ``sim`` to f32, allocates outputs and scratch with
``torch.empty``, launches on the current stream without synchronising,
raises on a non-zero ``cudaError_t``, and counts its launches in
``dml_pair_fused.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "dml_pair.cu"
BLOCK_Q = 64            # pairs of a tile
BLOCK_M = 128           # L rows of a tile
BLOCK_K = 32            # d slice staged per step
_WAVES = 4              # blocks per SM the d split aims for

_lib = None
_n_sm: dict = {}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dml_pair_launch.argtypes = [p] * 8 + [i] * 5 + [f, f, p]
        lib.dml_pair_launch.restype = i
        for name in ("block_q", "block_m", "block_k"):
            getattr(lib, f"dml_pair_{name}").restype = i
        if (lib.dml_pair_block_q(), lib.dml_pair_block_m(),
                lib.dml_pair_block_k()) != (BLOCK_Q, BLOCK_M, BLOCK_K):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tile sizes")
        _lib = lib
    return _lib


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(B: int, d: int, k: int, n_sm: int):
    """The d split that fills ``_WAVES * n_sm`` blocks: ``ksplit`` slices
    of ``kchunk`` columns (a multiple of ``BLOCK_K``)."""
    tiles = _cdiv(B, BLOCK_Q) * _cdiv(k, BLOCK_M)
    ksplit = max(1, min(_cdiv(_WAVES * n_sm, tiles), _cdiv(d, BLOCK_K)))
    kchunk = _cdiv(_cdiv(d, ksplit), BLOCK_K) * BLOCK_K
    return _cdiv(d, kchunk), kchunk


def _check(name, x, ndim):
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dml_pair_fused(L: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                   sim: torch.Tensor, *, lam: float = 1.0,
                   margin: float = 1.0):
    """Fused Eq. 4 forward on the card.

    Args:
      L:   (k, d) f32 metric factor.
      xs, ys: (B, d) f32 pair members.
      sim: (B,) 1 for similar pairs, 0 for dissimilar (int or float;
           cast to f32 here).

    Returns (losses (B,), d2 (B,), proj (B, k)), all f32.
    """
    for name, x, nd in (("L", L, 2), ("xs", xs, 2), ("ys", ys, 2)):
        _check(name, x, nd)
    device = xs.device
    if device.type != "cuda":
        raise ValueError(f"dml_pair_fused runs on CUDA tensors, got "
                         f"{device}")
    for name, x in (("L", L), ("ys", ys), ("sim", sim)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
    k, d = L.shape
    B = xs.shape[0]
    if xs.shape != ys.shape or xs.shape[1] != d or tuple(sim.shape) != (B,):
        raise ValueError(f"shape mismatch: L {tuple(L.shape)}, xs "
                         f"{tuple(xs.shape)}, ys {tuple(ys.shape)}, sim "
                         f"{tuple(sim.shape)}")
    f32 = dict(dtype=torch.float32, device=device)
    losses = torch.empty((B,), **f32)
    d2 = torch.empty((B,), **f32)
    proj = torch.empty((B, k), **f32)
    if B == 0:
        return losses, d2, proj
    lib = _library()
    ksplit, kchunk = split_plan(B, d, k, _sm_count(device))
    simf = sim.to(torch.float32).contiguous()
    part = torch.empty((ksplit, B, k), **f32)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (L, xs, ys, simf, part, losses, d2, proj)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.dml_pair_launch(*ptrs, B, d, k, ksplit, kchunk,
                                  float(lam), float(margin), stream)
    if err != 0:
        raise RuntimeError(f"dml_pair kernel launch failed: cudaError_t "
                           f"{err}")
    dml_pair_fused.launches += 1
    return losses, d2, proj


dml_pair_fused.launches = 0
