"""ctypes wrapper of the hand-written Hopper kernel ``csrc/pq_adc.cu``.

Counterpart of ``repro/kernels/pq_adc/kernel.py::pq_adc_topk_fused``:
per query, ADC-score the uint8 code rows of its probed segments against
its lookup table and keep the top kk, bit-identical to the plain version
(ref.py). The query's table lives in shared memory, so S * K * 4 bytes
plus the code tiles and lists must fit one block's 227 KB: the wrapper
raises ``ValueError`` when they do not (there is no other path). The
library is built on first use (``kernels/_build.py``); nothing here
touches CUDA at import time. Launches on the current stream without
synchronising, raises on a non-zero ``cudaError_t``, and counts its calls
in ``pq_adc_topk_fused.launches`` (one call = the scan and merge
launches).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import (check_kk, check_tensor,
                                         round_up, segment_split, sm_count)

SOURCE = Path(__file__).resolve().parent / "csrc" / "pq_adc.cu"
MAX_KK = 256            # the kernel keeps lists of <= 256 entries
TILE_ROWS = 256         # code rows of a tile: one a thread
SMEM_LIMIT = 232_448    # a block's shared memory on the H100

_lib = None


def smem_bytes(S: int, K: int, kk: int) -> int:
    """Dynamic shared memory of one scan block (as ``csrc`` computes it):
    the S x K f32 table, two code tiles of 256 rows (plus room for the
    16-byte alignment of their start) and nine (d, position) lists of kk."""
    tile = round_up(TILE_ROWS * S + 16, 16)
    return round_up(4 * S * K, 16) + 2 * tile + 9 * kk * 8


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pq_adc_launch.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.pq_adc_launch.restype = i
        lib.pq_adc_max_k.restype = i
        lib.pq_adc_tile_rows.restype = i
        lib.pq_adc_smem_bytes.argtypes = [i, i, i]
        lib.pq_adc_smem_bytes.restype = ctypes.c_longlong
        if (lib.pq_adc_max_k(), lib.pq_adc_tile_rows(),
                lib.pq_adc_smem_bytes(100, 256, 50),
                lib.pq_adc_smem_bytes(3, 2, 7)) != (
                    MAX_KK, TILE_ROWS, smem_bytes(100, 256, 50),
                    smem_bytes(3, 2, 7)):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tile and shared-memory sizes")
        _lib = lib
    return _lib


def check_fits(S: int, K: int, kk: int) -> None:
    """Raise ValueError when a block's table, tiles and lists do not fit
    its shared memory."""
    need = smem_bytes(S, K, kk)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"pq_adc needs {need} bytes of shared memory a block for an "
            f"S={S} x K={K} LUT ({4 * S * K} bytes), code tiles and kk={kk} "
            f"lists, above the {SMEM_LIMIT} one block can have")


def pq_adc_topk_fused(probes: torch.Tensor, tables: torch.Tensor,
                      dc: torch.Tensor, codes: torch.Tensor, t: torch.Tensor,
                      ids: torch.Tensor, *, n_codes: int, cap: int, kk: int):
    """Fused ADC scan + top-kk over probed code segments, on the card.

    Args:
      probes: (Nq, nprobe) int32 probed cluster ids (clipped to [0, C)).
      tables: (Nq, S*K) f32 flattened LUTs.
      dc: (Nq, nprobe) f32 squared centroid distances of the probes.
      codes: (C*cap, S) uint8 segment codes; t: (C*cap,) f32 row terms
        (+BIG pads); ids: (C*cap,) int32 row ids (-1 pads).
      n_codes: codewords per subspace (K); cap: rows per segment; kk:
        candidates kept (1..256, <= nprobe * cap).

    Returns (dists (Nq, kk) f32, ids (Nq, kk) int32) in (distance,
    candidate position) order; ops.py masks d >= BIG to id -1 and sorts
    by (distance, id).
    """
    device = tables.device
    if device.type != "cuda":
        raise ValueError(f"pq_adc_topk_fused runs on CUDA tensors, got "
                         f"{device}")
    for name, x, dt, nd in (("probes", probes, torch.int32, 2),
                            ("tables", tables, torch.float32, 2),
                            ("dc", dc, torch.float32, 2),
                            ("codes", codes, torch.uint8, 2),
                            ("t", t, torch.float32, 1),
                            ("ids", ids, torch.int32, 1)):
        check_tensor(name, x, dt, nd, device)
    nq, nprobe = probes.shape
    rows, S = codes.shape
    K = n_codes
    if (tables.shape != (nq, S * K) or dc.shape != (nq, nprobe)
            or t.shape[0] != rows or ids.shape[0] != rows or cap < 1
            or rows % cap):
        raise ValueError(f"shape mismatch: probes {tuple(probes.shape)}, "
                         f"tables {tuple(tables.shape)}, dc "
                         f"{tuple(dc.shape)}, codes {tuple(codes.shape)}, t "
                         f"{tuple(t.shape)}, ids {tuple(ids.shape)}, K {K}, "
                         f"cap {cap}")
    check_kk(kk, nprobe, cap)
    if kk > MAX_KK:
        raise ValueError(f"kk={kk} > {MAX_KK}: the CUDA pq_adc kernel keeps "
                         f"at most {MAX_KK} candidates per query")
    check_fits(S, K, kk)
    if codes.data_ptr() % 16:               # the tile copies are 16-byte
        codes = codes.clone()
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=device)
    out_i = torch.empty((nq, kk), dtype=torch.int32, device=device)
    if nq == 0:
        return out_d, out_i
    lib = _library()
    nchunk, rpc = segment_split(nq, nprobe, cap, sm_count(device), TILE_ROWS)
    cand_d = torch.empty((nq, nprobe * nchunk, kk), dtype=torch.float32,
                         device=device)
    cand_p = torch.empty((nq, nprobe * nchunk, kk), dtype=torch.int32,
                         device=device)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
            (probes, tables, dc, codes, t, ids, cand_d, cand_p, out_d, out_i)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.pq_adc_launch(*ptrs, nq, nprobe, rows // cap, cap, S, K, kk,
                                rpc, nchunk, stream)
    if err != 0:
        raise RuntimeError(f"pq_adc kernel launch failed: cudaError_t {err}")
    pq_adc_topk_fused.launches += 1
    return out_d, out_i


pq_adc_topk_fused.launches = 0
