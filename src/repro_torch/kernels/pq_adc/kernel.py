"""ctypes wrapper of the hand-written Hopper kernel ``csrc/pq_adc.cu``.

Counterpart of ``repro/kernels/pq_adc/kernel.py::pq_adc_topk_fused``:
per query, ADC-score the uint8 code rows of its probed segments against
its lookup table and keep the top kk, bit-identical to the plain version
(ref.py), for every kk the reference takes (1 <= kk <= nprobe * cap) and
every table size. A block takes one query and a unit of its pieces (a
piece is one probe's chunk of 256 segment rows; ``unit_plan`` sizes the
units) and stages the query's table once. ``lut_plan`` picks how the
table sits in a block's shared memory: whole, beside two or one tiles of
two whole-row pieces, when they fit, else in chunks of subspaces (the
partial sums carried in ascending subspace order, so the result is
unchanged). Lists of up to ``LIST_K`` candidates are kept in shared
memory; a wider kk takes the wide path (every distance to a scratch
buffer, then a radix select). The library is built on first use
(``kernels/_build.py``); nothing here touches CUDA at import time.
Launches on the current stream without synchronising, raises on a
non-zero ``cudaError_t``, and counts its calls in
``pq_adc_topk_fused.launches`` (one call = the scan and the merge or
select launches).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import (cdiv, check_kk, check_tensor,
                                         event_handles, round_up,
                                         segment_scratch, sm_count)

SOURCE = Path(__file__).resolve().parent / "csrc" / "pq_adc.cu"
LIST_K = 256            # widest per-block lists; a wider kk goes wide
PIECE_ROWS = 256        # segment rows of a piece: one a thread
TILE_PIECES = 2         # pieces a tile: rows a thread
SMEM_LIMIT = 232_448 - 1024     # a block's shared memory, less static use

_lib = None


def smem_bytes(S: int, K: int, kk: int, sc: int = None,
               nstage: int = 2) -> int:
    """Dynamic shared memory of one scan block (as ``csrc`` computes it)
    with the table in chunks of ``sc`` subspaces (default: whole): the
    S x K f32 table and ``nstage`` tiles of two pieces of 256 whole rows
    (each with room for the 16-byte alignment of its start) when sc = S,
    else an sc x K table chunk and one tile of sc code bytes a row; and
    twelve (d, position) lists of kk, the eight warps' and room to merge
    them (none on the wide path, kk > LIST_K)."""
    sc = S if sc is None else sc
    lists = 12 * kk * 8 if kk <= LIST_K else 0
    if sc >= S:
        return (round_up(4 * S * K, 16) + nstage * TILE_PIECES
                * round_up(PIECE_ROWS * S + 16, 16) + lists)
    return (round_up(4 * sc * K, 16)
            + TILE_PIECES * round_up(PIECE_ROWS * sc, 16) + lists)


def lut_plan(S: int, K: int, kk: int):
    """(subspaces of a table chunk, code tiles in flight): (S, 2) when the
    whole table fits beside two tiles, else (S, 1) beside one, else the
    most subspaces that fit the chunked plan, (sc, 1). Raises ValueError
    when not even one subspace fits."""
    for nstage in (2, 1):
        if smem_bytes(S, K, kk, S, nstage) <= SMEM_LIMIT:
            return S, nstage
    fits = [sc for sc in range(1, S) if smem_bytes(S, K, kk, sc) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"pq_adc cannot fit one K={K} table subspace, a code tile and "
            f"kk={kk} lists in the {SMEM_LIMIT} bytes of shared memory a "
            f"block can have")
    return fits[-1], 1


def unit_plan(nq: int, nprobe: int, cap: int, n_sm: int, waves: int = 4):
    """Pieces a block (``ppb``) and blocks a query (``nunits``): a query's
    nprobe * ceil(cap / 256) pieces dealt out so that the Nq * nunits
    blocks fill about ``waves`` blocks an SM (one block an SM fits beside
    a whole 100 x 256 table), ppb even so that tiles hold two pieces."""
    npieces = nprobe * cdiv(cap, PIECE_ROWS)
    ppb = cdiv(nq * npieces, waves * n_sm)
    if ppb > 1:
        ppb = round_up(ppb, TILE_PIECES)
    ppb = max(1, min(npieces, ppb))
    return ppb, cdiv(npieces, ppb)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pq_adc_launch.argtypes = [p] * 11 + [i] * 10 + [p, p, p]
        lib.pq_adc_launch.restype = i
        lib.pq_adc_max_k.restype = i
        lib.pq_adc_piece_rows.restype = i
        lib.pq_adc_smem_bytes.argtypes = [i] * 5
        lib.pq_adc_smem_bytes.restype = ctypes.c_longlong
        cases = ((100, 256, 50, 100, 2), (3, 2, 7, 3, 1),
                 (200, 256, 10, 120, 1), (200, 256, 0, 150, 1),
                 (128, 256, 256, 128, 1))
        if (lib.pq_adc_max_k(), lib.pq_adc_piece_rows(),
                [lib.pq_adc_smem_bytes(*c) for c in cases]) != (
                    LIST_K, PIECE_ROWS, [smem_bytes(*c) for c in cases]):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"piece and shared-memory sizes")
        _lib = lib
    return _lib


def pq_adc_topk_fused(probes: torch.Tensor, tables: torch.Tensor,
                      dc: torch.Tensor, codes: torch.Tensor, t: torch.Tensor,
                      ids: torch.Tensor, *, n_codes: int, cap: int, kk: int,
                      stamps: torch.Tensor = None, marks=None):
    """Fused ADC scan + top-kk over probed code segments, on the card.

    Args:
      probes: (Nq, nprobe) int32 probed cluster ids (clipped to [0, C)).
      tables: (Nq, S*K) f32 flattened LUTs.
      dc: (Nq, nprobe) f32 squared centroid distances of the probes.
      codes: (C*cap, S) uint8 segment codes; t: (C*cap,) f32 row terms
        (+BIG pads); ids: (C*cap,) int32 row ids (-1 pads).
      n_codes: codewords per subspace (K); cap: rows per segment; kk:
        candidates kept (1 <= kk <= nprobe * cap).
      stamps: optional (blocks, 5) int64 on the card: each block's clock
        stamps (csrc's note), for a split of where the time goes.
      marks: optional three ``torch.cuda.Event``s, recorded before the
        scan, after it and after the merge (or select).

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
    sc, nstage = lut_plan(S, K, kk)
    if codes.data_ptr() % 16:               # the tile copies are 16-byte
        codes = codes.clone()
    if tables.data_ptr() % 16:              # the table's bulk copy too
        tables = tables.clone()
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=device)
    out_i = torch.empty((nq, kk), dtype=torch.int32, device=device)
    if nq == 0:
        return out_d, out_i
    lib = _library()
    ppb, nunits = unit_plan(nq, nprobe, cap, sm_count(device))
    cand_d, cand_p, dump = segment_scratch(nq, nunits, nprobe * cap, kk,
                                           LIST_K, device)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
            (probes, tables, dc, codes, t, ids, cand_d, cand_p, dump, out_d,
             out_i)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.pq_adc_launch(*ptrs, nq, nprobe, rows // cap, cap, S, K, kk,
                                sc, nstage, ppb,
                                ctypes.c_void_p(0 if stamps is None else
                                                stamps.data_ptr()),
                                event_handles(marks, 3), stream)
    if err != 0:
        raise RuntimeError(f"pq_adc kernel launch failed: cudaError_t {err}")
    pq_adc_topk_fused.launches += 1
    return out_d, out_i


pq_adc_topk_fused.launches = 0
