"""ctypes wrapper of the hand-written Hopper kernel ``csrc/pairwise_dist.cu``.

Counterpart of ``repro/kernels/pairwise_dist/kernel.py::pairwise_sqdist``:
all-pairs squared distances of projected points, any N, M and k (the
kernel masks its ragged edges). The library is built on first use
(``kernels/_build.py``); nothing here touches CUDA at import time. The
wrapper checks its inputs before it builds or launches anything,
allocates the output with ``torch.empty``, launches on the current
stream without synchronising, raises on a non-zero ``cudaError_t``, and
counts its launches in ``pairwise_sqdist.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise_dist.cu"
BLOCK_N = 64            # xp rows of a tile
BLOCK_M = 128           # yp rows of a tile
BLOCK_K = 32            # contraction slice staged per step
MAX_M = 65535 * BLOCK_M     # yp tiles run on the grid's y axis

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pairwise_dist_launch.argtypes = [p] * 3 + [i] * 3 + [p]
        lib.pairwise_dist_launch.restype = i
        for name in ("block_n", "block_m", "block_k"):
            getattr(lib, f"pairwise_dist_{name}").restype = i
        if (lib.pairwise_dist_block_n(), lib.pairwise_dist_block_m(),
                lib.pairwise_dist_block_k()) != (BLOCK_N, BLOCK_M, BLOCK_K):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tile sizes")
        _lib = lib
    return _lib


def _check(name, x):
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pairwise_sqdist(xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """xp (N, k), yp (M, k) f32 on the card -> (N, M) f32 squared
    distances ``max(||xp_i||^2 + ||yp_j||^2 - 2 xp_i . yp_j, 0)``."""
    _check("xp", xp)
    _check("yp", yp)
    device = xp.device
    if device.type != "cuda":
        raise ValueError(f"pairwise_sqdist runs on CUDA tensors, got "
                         f"{device}")
    if yp.device != device:
        raise ValueError(f"yp is on {yp.device}, expected {device}")
    (n, k), m = xp.shape, yp.shape[0]
    if yp.shape[1] != k or k < 1:
        raise ValueError(f"shape mismatch: xp {tuple(xp.shape)}, yp "
                         f"{tuple(yp.shape)}")
    if m > MAX_M:
        raise ValueError(f"yp has {m} rows; the kernel takes at most "
                         f"{MAX_M}")
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    if n == 0 or m == 0:
        return out
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.pairwise_dist_launch(
            ctypes.c_void_p(xp.data_ptr()), ctypes.c_void_p(yp.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), n, m, k, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_dist kernel launch failed: "
                           f"cudaError_t {err}")
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0
