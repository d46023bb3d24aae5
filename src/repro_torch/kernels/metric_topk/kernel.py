"""ctypes wrapper of the hand-written Hopper kernel ``csrc/metric_topk.cu``.

Counterpart of ``repro/kernels/metric_topk/kernel.py::metric_topk_fused``:
fused query projection + factored distance + top-k, for every k_top
the reference takes (1 <= k_top <= M). Up to ``LIST_K`` the per-query
lists stay in shared memory and the (Nq, M) distance matrix never
reaches device memory; a wider k_top takes the wide path (the scan
writes every distance to a scratch (Nq, M) buffer, a radix select keeps
the k_top smallest, and ``_dispatch.sort_by_distance_id`` orders them).
The library is built on first use (``kernels/_build.py``); nothing here
touches CUDA at import time. The wrapper checks its inputs, zero-pads the columns of q, L
or gp to a multiple of 4 where they are not (the TMA tensor maps'
16-byte row stride), allocates outputs and scratch with ``torch.empty``,
launches on the current stream without synchronising, raises on a
non-zero ``cudaError_t``, and counts its launches in
``metric_topk_fused.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import (cdiv, sm_count,
                                         sort_by_distance_id, tma_operand)

SOURCE = Path(__file__).resolve().parent / "csrc" / "metric_topk.cu"
LIST_K = 256            # widest per-query lists; a wider k_top goes wide
BLOCK_M = 128           # gallery (or L) rows of a tile: two warpgroups
BLOCK_K = 32            # columns of a TMA stage
QUERY_TILES = (8, 16, 32, 64, 128)  # query rows of a tile (the wgmma N)
PROJ_STAGES = 4         # the projection's TMA ring
MAX_STAGES = 8          # the scan's TMA ring: 2..8 stages, as many as fit
SMEM_LIMIT = 232448     # a block's shared memory on sm_90
ALIGN = 1024            # slack for the 128-byte-swizzle alignment
_ROW = BLOCK_K * 4      # bytes of a staged row
_A = BLOCK_M * _ROW     # a stage's M-side tile


class Plan(NamedTuple):
    n_tile: int             # query rows of a tile
    qtiles: int
    stages: int             # the scan's ring
    ksplit: int             # projection: d_in slices ...
    kchunk: int             # ... of kchunk columns, a multiple of 32
    nsplit: int             # scan: gallery splits ...
    rows_per_split: int     # ... of whole 128-row tiles


_lib = None


def scan_smem(n: int, k_top: int, stages: int) -> int:
    """Shared memory of a scan block (as ``scan_smem`` in the source):
    the ring of gp / qhi / qlo stages, the 128 x n cross tile (rows padded
    by 4), gn and qn, the n sorted lists of k_top (d, id) entries (none
    on the wide path, k_top > LIST_K), the barriers, the alignment
    slack."""
    lists = k_top if k_top <= LIST_K else 0
    return (ALIGN + stages * (_A + 2 * n * _ROW) + n * (BLOCK_M + 4) * 4
            + BLOCK_M * 4 + n * 4 + n * lists * 8 + 2 * stages * 8)


def proj_smem(n: int) -> int:
    """Shared memory of a projection block (``tf32x3::partial_smem``):
    the ring of L / q stages, two lo buffers of the query side."""
    return (ALIGN + PROJ_STAGES * (_A + n * _ROW) + 2 * n * _ROW
            + 2 * PROJ_STAGES * 8)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.metric_topk_launch.argtypes = [p] * 13 + [i] * 12 + [p]
        lib.metric_topk_launch.restype = i
        for name in ("block_m", "block_k", "max_k", "proj_stages",
                     "scan_smem", "proj_smem"):
            getattr(lib, f"metric_topk_{name}").restype = i
        ok = (lib.metric_topk_block_m(), lib.metric_topk_block_k(),
              lib.metric_topk_max_k(), lib.metric_topk_proj_stages()) == \
            (BLOCK_M, BLOCK_K, LIST_K, PROJ_STAGES)
        for n in QUERY_TILES:
            ok = ok and lib.metric_topk_proj_smem(n) == proj_smem(n)
            for kt, st in ((1, 2), (10, 4), (256, 3)):
                ok = ok and lib.metric_topk_scan_smem(n, kt, st) == \
                    scan_smem(n, kt, st)
        if not ok:
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tiles or shared memory")
        _lib = lib
    return _lib


def launch_plan(nq: int, d_in: int, d_out: int, m: int, k_top: int,
                n_sm: int) -> Plan:
    """The query tile (the smallest of ``QUERY_TILES`` that holds the
    batch, halved while a 2-stage scan block would not fit its lists),
    the scan's ring (up to ``MAX_STAGES`` that fit), the projection's d_in
    slices and the scan's gallery splits, each aiming at one block an SM
    (a scan block takes most of an SM's shared memory)."""
    n = next((b for b in QUERY_TILES if nq <= b), QUERY_TILES[-1])
    while n > QUERY_TILES[0] and scan_smem(n, k_top, 2) > SMEM_LIMIT:
        n //= 2
    stages = max(s for s in range(2, MAX_STAGES + 1)
                 if scan_smem(n, k_top, s) <= SMEM_LIMIT)
    qtiles = cdiv(nq, n)
    ksplit = max(1, min(n_sm // (cdiv(d_out, BLOCK_M) * qtiles),
                        cdiv(d_in, BLOCK_K)))
    kchunk = cdiv(cdiv(d_in, ksplit), BLOCK_K) * BLOCK_K
    mtiles = cdiv(m, BLOCK_M)
    nsplit = max(1, min(cdiv(n_sm, qtiles), mtiles))
    rows_per_split = cdiv(mtiles, nsplit) * BLOCK_M
    return Plan(n, qtiles, stages, cdiv(d_in, kchunk), kchunk,
                cdiv(m, rows_per_split), rows_per_split)


def _check(name, x, ndim, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def metric_topk_fused(q: torch.Tensor, L: torch.Tensor, gp: torch.Tensor,
                      gn: torch.Tensor, *, k_top: int = 10):
    """Fused project + distance + top-k on the card.

    Args:
      q:  (Nq, d_in) f32 raw queries.
      L:  (d_out, d_in) f32 metric factor.
      gp: (M, d_out) f32 pre-projected gallery rows.
      gn: (M,) f32 squared norms of gp rows.

    Returns (dists (Nq, k_top) f32 ascending, indices (Nq, k_top) int32),
    equal distances toward the smaller gallery index.
    """
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"metric_topk_fused runs on CUDA tensors, got "
                         f"{device}")
    for name, x, nd in (("q", q, 2), ("L", L, 2), ("gp", gp, 2),
                        ("gn", gn, 1)):
        _check(name, x, nd, device)
    nq, d_in = q.shape
    d_out, m = L.shape[0], gp.shape[0]
    if L.shape[1] != d_in or gp.shape[1] != d_out or gn.shape[0] != m:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, L "
                         f"{tuple(L.shape)}, gp {tuple(gp.shape)}, gn "
                         f"{tuple(gn.shape)}")
    if k_top < 1:
        raise ValueError(f"k_top={k_top} must be >= 1")
    if k_top > m:
        raise ValueError(f"k_top={k_top} > gallery size M={m}")
    out_d = torch.empty((nq, k_top), dtype=torch.float32, device=device)
    out_i = torch.empty((nq, k_top), dtype=torch.int32, device=device)
    if nq == 0:
        return out_d, out_i
    lib = _library()
    # rows of a multiple of 4 floats for the tensor maps (zero columns)
    q, L, gp = (tma_operand(t) for t in (q, L, gp))
    d_in4, dp = q.shape[1], gp.shape[1]
    plan = launch_plan(nq, d_in4, d_out, m, k_top, sm_count(device))
    f32 = dict(dtype=torch.float32, device=device)
    part = torch.empty((plan.ksplit, nq, d_out), **f32)
    qhi = torch.empty((nq, dp), **f32)
    qlo = torch.empty((nq, dp), **f32)
    qn = torch.empty((nq,), **f32)
    wide = k_top > LIST_K
    cand = (0, 0, 0) if wide else (nq, plan.nsplit, k_top)
    cand_d = torch.empty(cand, **f32)
    cand_i = torch.empty(cand, dtype=torch.int32, device=device)
    dump = torch.empty((nq, m) if wide else (0,), **f32)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (q, L, gp, gn, part, qhi, qlo, qn, cand_d, cand_i, dump, out_d,
             out_i)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.metric_topk_launch(
            *ptrs, nq, d_in4, d_out, dp, m, k_top, plan.n_tile, plan.stages,
            plan.ksplit, plan.kchunk, plan.nsplit, plan.rows_per_split,
            stream)
    if err != 0:
        raise RuntimeError(f"metric_topk kernel launch failed: cudaError_t "
                           f"{err}")
    metric_topk_fused.launches += 1
    if wide:                            # the selection comes unordered
        return sort_by_distance_id(out_d, out_i)
    return out_d, out_i


metric_topk_fused.launches = 0
