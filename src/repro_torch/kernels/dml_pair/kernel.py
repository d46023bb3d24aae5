"""ctypes wrapper of the hand-written Hopper kernel ``csrc/dml_pair.cu``.

Counterpart of ``repro/kernels/dml_pair/kernel.py::dml_pair_fused``: the
fused Eq. 4 forward, returning ``(losses, d2, proj)``. The library is
built on first use (``kernels/_build.py``); nothing here touches CUDA at
import time. The wrapper checks its inputs before it builds or launches
anything, casts ``sim`` to f32, zero-pads the columns of L, xs and ys
to a multiple of 4 where they are not (the TMA tensor maps' 16-byte row
stride), allocates outputs and scratch with ``torch.empty``, launches on
the current stream without synchronising, raises on a non-zero
``cudaError_t``, and counts its launches in ``dml_pair_fused.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import cdiv, sm_count, tma_operand

SOURCE = Path(__file__).resolve().parent / "csrc" / "dml_pair.cu"
BLOCK_M = 128           # pairs of a tile (two 64-row warpgroups)
BLOCK_N = 128           # L rows of a tile
BLOCK_K = 32            # d columns of a TMA stage
STAGES = 4              # the TMA ring
SMEM_LIMIT = 232448     # a block's shared memory on sm_90
ALIGN = 1024            # slack for the 128-byte-swizzle alignment


class Plan(NamedTuple):
    grid: Tuple[int, int, int]  # (pair tiles, L-row tiles, d slices)
    ksplit: int                 # d slices ...
    kchunk: int                 # ... of kchunk columns, a multiple of 32


_lib = None


def smem_bytes(stages: int = STAGES) -> int:
    """Shared memory of one block: the ring of raw xs / ys / L stages,
    two lo buffers of L, the barriers and the alignment slack (as
    ``tf32x3::partial_smem`` counts it)."""
    stage = (2 * BLOCK_M + BLOCK_N) * BLOCK_K * 4
    return ALIGN + stages * stage + 2 * BLOCK_N * BLOCK_K * 4 + 2 * stages * 8


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dml_pair_launch.argtypes = [p] * 8 + [i] * 5 + [f, f, p]
        lib.dml_pair_launch.restype = i
        names = ("block_m", "block_n", "block_k", "stages", "smem")
        for name in names:
            getattr(lib, f"dml_pair_{name}").restype = i
        got = tuple(getattr(lib, f"dml_pair_{n}")() for n in names)
        if got != (BLOCK_M, BLOCK_N, BLOCK_K, STAGES, smem_bytes()):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tiles or shared memory: {got}")
        _lib = lib
    return _lib


def launch_plan(B: int, d: int, k: int, n_sm: int) -> Plan:
    """One block an SM (a block takes ``smem_bytes()``): the (pair, L-row)
    tiles, and d split into as many slices as the tiles leave SMs for
    (one wave), each a whole number of 32-column stages."""
    tiles = cdiv(B, BLOCK_M) * cdiv(k, BLOCK_N)
    ksplit = max(1, min(n_sm // tiles, cdiv(d, BLOCK_K)))
    kchunk = cdiv(cdiv(d, ksplit), BLOCK_K) * BLOCK_K
    ksplit = cdiv(d, kchunk)
    return Plan((cdiv(B, BLOCK_M), cdiv(k, BLOCK_N), ksplit), ksplit, kchunk)


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
    # rows of a multiple of 4 floats for the tensor maps (zero columns)
    L, xs, ys = (tma_operand(t) for t in (L, xs, ys))
    d4 = xs.shape[1]
    plan = launch_plan(B, d4, k, sm_count(device))
    simf = sim.to(torch.float32).contiguous()
    part = torch.empty((plan.ksplit, B, k), **f32)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (L, xs, ys, simf, part, losses, d2, proj)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.dml_pair_launch(*ptrs, B, d4, k, plan.ksplit, plan.kchunk,
                                  float(lam), float(margin), stream)
    if err != 0:
        raise RuntimeError(f"dml_pair kernel launch failed: cudaError_t "
                           f"{err}")
    dml_pair_fused.launches += 1
    return losses, d2, proj


dml_pair_fused.launches = 0
