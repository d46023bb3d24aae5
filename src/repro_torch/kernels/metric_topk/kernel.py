"""ctypes wrapper of the hand-written Hopper kernel ``csrc/metric_topk.cu``.

Counterpart of ``repro/kernels/metric_topk/kernel.py::metric_topk_fused``:
fused query projection + factored distance + top-k, without the
(Nq, M) distance matrix ever reaching device memory. The library is
built on first use (``kernels/_build.py``); nothing here touches CUDA at
import time. The wrapper checks its inputs, allocates outputs and
scratch with ``torch.empty``, launches on the current stream without
synchronising, raises on a non-zero ``cudaError_t``, and counts its
launches in ``metric_topk_fused.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "metric_topk.cu"
MAX_K_TOP = 256         # the kernel keeps per-query lists of <= 256 entries
BLOCK_M = 128           # gallery (or L) rows of a tile
BLOCK_K = 32            # contraction slice staged per step
QUERY_TILES = (8, 16, 32, 64)   # query rows of a tile, chosen per batch
_WAVES = 4              # blocks per SM the split sizes aim for

_lib = None
_n_sm: dict = {}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.metric_topk_launch.argtypes = [p] * 11 + [i] * 10 + [p]
        lib.metric_topk_launch.restype = i
        for name in ("block_m", "block_k", "max_k"):
            getattr(lib, f"metric_topk_{name}").restype = i
        if (lib.metric_topk_block_m(), lib.metric_topk_block_k(),
                lib.metric_topk_max_k()) != (BLOCK_M, BLOCK_K, MAX_K_TOP):
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


def split_plan(nq: int, d_in: int, d_out: int, m: int, n_sm: int):
    """Launch plan that fills ``_WAVES * n_sm`` blocks: the query tile
    (the smallest of ``QUERY_TILES`` that holds the batch), the
    projection's d_in slices (``ksplit`` of ``kchunk`` columns) and the
    scan's gallery splits (``nsplit`` of ``rows_per_split`` rows)."""
    block_q = next((b for b in QUERY_TILES if nq <= b), QUERY_TILES[-1])
    target = _WAVES * n_sm
    qtiles = _cdiv(nq, block_q)
    ksplit = max(1, min(_cdiv(target, qtiles * _cdiv(d_out, BLOCK_M)),
                        _cdiv(d_in, BLOCK_K)))
    kchunk = _cdiv(_cdiv(d_in, ksplit), BLOCK_K) * BLOCK_K
    ksplit = _cdiv(d_in, kchunk)
    mtiles = _cdiv(m, BLOCK_M)
    nsplit = max(1, min(_cdiv(target, qtiles), mtiles))
    rows_per_split = _cdiv(mtiles, nsplit) * BLOCK_M
    nsplit = _cdiv(m, rows_per_split)
    return block_q, ksplit, kchunk, nsplit, rows_per_split


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
    if not 1 <= k_top <= MAX_K_TOP:
        raise ValueError(f"k_top={k_top} outside 1..{MAX_K_TOP}: the CUDA "
                         f"metric_topk kernel keeps at most {MAX_K_TOP} "
                         f"neighbours per query")
    if k_top > m:
        raise ValueError(f"k_top={k_top} > gallery size M={m}")
    out_d = torch.empty((nq, k_top), dtype=torch.float32, device=device)
    out_i = torch.empty((nq, k_top), dtype=torch.int32, device=device)
    if nq == 0:
        return out_d, out_i
    lib = _library()
    block_q, ksplit, kchunk, nsplit, rps = split_plan(
        nq, d_in, d_out, m, _sm_count(device))
    f32 = dict(dtype=torch.float32, device=device)
    part = torch.empty((ksplit, nq, d_out), **f32)
    qp = torch.empty((nq, d_out), **f32)
    qn = torch.empty((nq,), **f32)
    cand_d = torch.empty((nq, nsplit, k_top), **f32)
    cand_i = torch.empty((nq, nsplit, k_top), dtype=torch.int32,
                         device=device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (q, L, gp, gn, part, qp, qn, cand_d, cand_i, out_d, out_i)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.metric_topk_launch(*ptrs, nq, d_in, d_out, m, k_top,
                                     block_q // 8, ksplit, kchunk, nsplit,
                                     rps, stream)
    if err != 0:
        raise RuntimeError(f"metric_topk kernel launch failed: cudaError_t "
                           f"{err}")
    metric_topk_fused.launches += 1
    return out_d, out_i


metric_topk_fused.launches = 0
