"""ctypes wrapper of the hand-written Hopper kernel ``csrc/pairwise_dist.cu``.

Counterpart of ``repro/kernels/pairwise_dist/kernel.py::pairwise_sqdist``:
all-pairs squared distances of projected points, any N, M and k, on the
TMA-fed 3xTF32 ``wgmma`` mainloop of ``kernels/csrc/tf32x3_sm90.cuh``
with the distance epilogue on its accumulator. The library is built on
first use (``kernels/_build.py``); nothing here touches CUDA at import
time. The wrapper checks its inputs before it builds or launches
anything, zero-pads the columns of xp and yp to a multiple of 4 where
they are not (the tensor maps' 16-byte row stride), allocates the output
and the row-norm scratch with ``torch.empty``, launches on the current
stream without synchronising, raises on a non-zero ``cudaError_t``, and
counts its calls in ``pairwise_sqdist.launches`` (one call = the row
norms and the product).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import tma_operand

SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise_dist.cu"
BLOCK_M = 128           # xp rows of a tile: two warpgroups (the wgmma M)
BLOCK_N = 128           # yp rows of a tile (the wgmma N)
BLOCK_K = 32            # columns of a TMA stage
STAGES = 4              # the TMA ring
SMEM = 1024 + STAGES * (BLOCK_M + BLOCK_N) * BLOCK_K * 4 \
    + 2 * BLOCK_N * BLOCK_K * 4 + 2 * STAGES * 8    # tf32x3::partial_smem

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pairwise_dist_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.pairwise_dist_launch.restype = i
        for name in ("block_m", "block_n", "block_k", "stages", "smem"):
            getattr(lib, f"pairwise_dist_{name}").restype = i
        if (lib.pairwise_dist_block_m(), lib.pairwise_dist_block_n(),
                lib.pairwise_dist_block_k(), lib.pairwise_dist_stages(),
                lib.pairwise_dist_smem()) != (BLOCK_M, BLOCK_N, BLOCK_K,
                                              STAGES, SMEM):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tiles or shared memory")
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
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    if n == 0 or m == 0:
        return out
    lib = _library()
    # rows of a multiple of 4 floats for the tensor maps (zero columns)
    xp, yp = tma_operand(xp), tma_operand(yp)
    xn = torch.empty((n,), dtype=torch.float32, device=device)
    yn = torch.empty((m,), dtype=torch.float32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.pairwise_dist_launch(
            *(ctypes.c_void_p(t.data_ptr()) for t in (xp, yp, xn, yn, out)),
            n, m, k, xp.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"pairwise_dist kernel launch failed: "
                           f"cudaError_t {err}")
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0
