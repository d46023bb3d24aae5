"""ctypes wrapper of the hand-written Hopper kernel ``csrc/ivf_scan.cu``.

Counterpart of ``repro/kernels/ivf_scan/kernel.py::ivf_scan_topk_fused``:
per query, score the rows of its probed full-precision segments with
the factored distance and keep the top kk, without the (Nq, nprobe,
cap, k) segment gather reaching device memory, for every kk the
reference takes (1 <= kk <= nprobe * cap): lists of up to ``LIST_K``
candidates are kept in shared memory; a wider kk takes the wide path
(every distance to a scratch buffer, then a radix select). The library
is built on first use (``kernels/_build.py``); nothing here touches CUDA
at import time. The wrapper checks its inputs, allocates outputs and
scratch with ``torch.empty``, launches on the current stream without
synchronising, raises on a non-zero ``cudaError_t``, and counts its calls
in ``ivf_scan_topk_fused.launches`` (one call = the scan and the merge
or select launches).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import (check_kk, check_tensor,
                                         segment_scratch, segment_split,
                                         sm_count)

SOURCE = Path(__file__).resolve().parent / "csrc" / "ivf_scan.cu"
LIST_K = 256            # widest per-block lists; a wider kk goes wide
TILE_ROWS = 32          # segment rows of a tile (8 warps x 4 rows)
SLICE = 128             # k floats of a staged slice
SMEM_LIMIT = 232_448 - 1024     # a block's shared memory, less static use

_lib = None


def smem_bytes(k: int, kk: int) -> int:
    """Dynamic shared memory of one scan block (as ``csrc`` computes it):
    two 32 x 128 f32 slices, the query row padded to the slice, and nine
    (d, position) lists of kk (eight warps' and the block's; none on the
    wide path, kk > LIST_K)."""
    kpad = -(-k // SLICE) * SLICE
    lists = 9 * kk * 8 if kk <= LIST_K else 0
    return 2 * TILE_ROWS * SLICE * 4 + 4 * kpad + lists


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ivf_scan_launch.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.ivf_scan_launch.restype = i
        lib.ivf_scan_max_k.restype = i
        lib.ivf_scan_tile_rows.restype = i
        lib.ivf_scan_smem_bytes.argtypes = [i, i]
        lib.ivf_scan_smem_bytes.restype = ctypes.c_longlong
        if (lib.ivf_scan_max_k(), lib.ivf_scan_tile_rows(),
                lib.ivf_scan_smem_bytes(1000, 50)) != (
                    LIST_K, TILE_ROWS, smem_bytes(1000, 50)):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tile and shared-memory sizes")
        _lib = lib
    return _lib


def ivf_scan_topk_fused(probes: torch.Tensor, qp: torch.Tensor,
                        g: torch.Tensor, gn: torch.Tensor, ids: torch.Tensor,
                        *, cap: int, kk: int):
    """Fused probed-segment scan + top-kk on the card.

    Args:
      probes: (Nq, nprobe) int32 probed cluster ids (clipped to [0, C)).
      qp: (Nq, k) f32 projected queries.
      g: (C*cap, k) f32 cluster-major segment rows; gn: (C*cap,) f32 row
        norms (+BIG pads); ids: (C*cap,) int32 row ids (-1 pads).
      cap: rows per segment; kk: candidates kept (1 <= kk <= nprobe*cap).

    Returns (dists (Nq, kk) f32, ids (Nq, kk) int32) in (distance,
    candidate position) order; ops.py masks d >= BIG to id -1 and sorts
    by (distance, id).
    """
    device = qp.device
    if device.type != "cuda":
        raise ValueError(f"ivf_scan_topk_fused runs on CUDA tensors, got "
                         f"{device}")
    for name, x, dt, nd in (("probes", probes, torch.int32, 2),
                            ("qp", qp, torch.float32, 2),
                            ("g", g, torch.float32, 2),
                            ("gn", gn, torch.float32, 1),
                            ("ids", ids, torch.int32, 1)):
        check_tensor(name, x, dt, nd, device)
    nq, nprobe = probes.shape
    rows, k = g.shape
    if (qp.shape != (nq, k) or gn.shape[0] != rows or ids.shape[0] != rows
            or cap < 1 or rows % cap):
        raise ValueError(f"shape mismatch: probes {tuple(probes.shape)}, qp "
                         f"{tuple(qp.shape)}, g {tuple(g.shape)}, gn "
                         f"{tuple(gn.shape)}, ids {tuple(ids.shape)}, "
                         f"cap {cap}")
    check_kk(kk, nprobe, cap)
    if smem_bytes(k, kk) > SMEM_LIMIT:
        raise ValueError(f"k={k}, kk={kk} need {smem_bytes(k, kk)} bytes of "
                         f"shared memory a block, above {SMEM_LIMIT}")
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=device)
    out_i = torch.empty((nq, kk), dtype=torch.int32, device=device)
    if nq == 0:
        return out_d, out_i
    lib = _library()
    nchunk, rpc = segment_split(nq, nprobe, cap, sm_count(device), TILE_ROWS)
    cand_d, cand_p, dump = segment_scratch(nq, nprobe, nchunk, cap, kk,
                                           LIST_K, device)
    vec4 = int(k % 4 == 0 and g.data_ptr() % 16 == 0)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (probes, qp, g, gn, ids, cand_d, cand_p, dump, out_d, out_i)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.ivf_scan_launch(*ptrs, nq, nprobe, rows // cap, cap, k, kk,
                                  rpc, nchunk, vec4, stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: cudaError_t "
                           f"{err}")
    ivf_scan_topk_fused.launches += 1
    return out_d, out_i


ivf_scan_topk_fused.launches = 0
