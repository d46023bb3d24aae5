"""Shared kernel-dispatch helpers: factor validation, padding, tiling.

Counterpart of ``repro/kernels/_dispatch.py``. Dispatch between a kernel
and its plain version goes by the tensor's device (CUDA -> kernel, CPU
-> plain), so there is no ``default_interpret`` here. The CUDA kernels
mask their ragged edges themselves (TMA zero-fills them in dml_pair and
metric_topk); ``round_up`` / ``pad_axis`` / ``pick_block`` serve the
plain paths and the wrappers' scratch sizing.
``topk_by_distance`` is the one tie-breaking contract every scan path
must agree on: ascending distance, equal distances smallest-id-first.
``full_f32`` is the one place the plain paths pin full-f32 products;
``tf32x3_matmul`` is a plain model of the 3xTF32 products the Hopper
kernels run: ``tests/test_torch_tf32x3.py`` holds it to the kernels'
tolerances at full width, and ``chip_smoke.py`` prints its error beside
``dml_pair``'s at the training width; no main path calls it.
``tma_operand`` zero-pads an operand's columns to the 16-byte row stride
a TMA tensor map needs.
``BIG`` is the pad sentinel of the segment layouts (IVF / IVFPQ);
``check_kk``, ``segment_split``, ``segment_scratch``, ``event_handles``,
``check_tensor`` and ``sm_count`` serve the two segment-scan wrappers
(ivf_scan, pq_adc).
"""

from __future__ import annotations

import ctypes

import torch

# pad-slot sentinel: +BIG row norms / t terms on segment pads (the
# reference's metric_topk.kernel.BIG); real distances never reach it
BIG = 1e30


def full_f32():
    """Switch TF32 off for float32 matrix products on the card.

    TF32 keeps about three decimal digits, and one call of
    ``torch.set_float32_matmul_precision("high")`` anywhere in the process
    turns it on for ``torch.matmul``. Parity with the kernels and with the
    JAX reference (whose f32 products on the CPU are full f32) needs true
    f32, so every plain path and every backward product calls this first.
    """
    torch.backends.cuda.matmul.allow_tf32 = False


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), by bit masking; finite inputs."""
    bits = x.contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000          # half of the dropped ulp
    return ((mag & ~0x1FFF) | (bits & ~0x7FFFFFFF)).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32."""
    x = x.to(torch.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T as the kernels take it on the tensor cores: each operand
    split into TF32 hi and lo, hi.lo + lo.hi + hi.hi with f32
    accumulation (the lo.lo term dropped). Each TF32 product is exact in
    f32, so the model's only rounding beyond the split is f32
    accumulation. a (n, k), b (m, k) -> (n, m) f32."""
    full_f32()
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bl.T + al @ bh.T + ah @ bh.T


def tma_operand(x: torch.Tensor) -> torch.Tensor:
    """A 2-D f32 operand as a TMA tensor map takes it: rows a multiple of
    16 bytes (4 floats) long from a 16-byte aligned base. Returns ``x``
    itself when it already is, else a copy with its columns zero-padded
    to a multiple of 4 (zero columns change no product and no norm)."""
    cols = x.shape[1]
    if cols % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((x.shape[0], round_up(cols, 4)))
    out[:, :cols] = x
    return out


def check_metric_factor(L, d_in=None, *, what: str = "L"):
    """Validate the ``(d_out, d_in)`` metric-factor contract up front.

    L is 2-D with raw features on the *second* axis; rectangular
    ``d_out < d_in`` is as legal as square. A transposed / 1-D /
    wrong-dim factor raises one clear ValueError (same messages as the
    reference). Returns L unchanged.
    """
    shape = tuple(L.shape)
    if len(shape) != 2:
        raise ValueError(
            f"{what} must be a 2-D (d_out, d_in) metric factor, got "
            f"shape {shape}")
    d_out, d = shape
    if d_out < 1 or d < 1:
        raise ValueError(
            f"{what} must have d_out >= 1 and d_in >= 1, got shape "
            f"{shape}")
    if d_in is not None and d != d_in:
        # rows matching the data dim is the transposed-factor signature
        hint = (" — transposed factor? the contract is rows = d_out, "
                "columns = d_in" if d_out == d_in else "")
        raise ValueError(
            f"{what} has d_in={d} but the data is {d_in}-dimensional; "
            f"expected {what}.shape == (d_out, {d_in}){hint}")
    return L


def check_kk(kk: int, nprobe: int, cap: int) -> None:
    """Validate a segment scan's kk against its probed candidate pool
    (the reference's messages): an explicit 0 raises, never remaps."""
    if kk < 1:
        raise ValueError(f"kk must be >= 1, got {kk}")
    if kk > nprobe * cap:
        raise ValueError(f"kk={kk} > nprobe*cap={nprobe * cap} scanned "
                         f"rows per query")


def segment_split(units: int, cap: int, n_sm: int, tile_rows: int,
                  waves: int = 4):
    """Row chunks per segment of a segment scan that launches one block
    per (unit of work, chunk): (nchunk, rows_per_chunk). A segment is cut
    into chunks of whole tiles only when ``units`` blocks would not fill
    ``waves * n_sm``; ``nchunk * rows_per_chunk >= cap`` and the last
    chunk is non-empty."""
    nchunk = max(1, min(cdiv(waves * n_sm, max(units, 1)),
                        cdiv(cap, tile_rows)))
    rows = round_up(cdiv(cap, nchunk), tile_rows)
    return cdiv(cap, rows), rows


def segment_scratch(nq: int, nlists: int, pool: int, kk: int, list_k: int,
                    device):
    """Scratch of a segment scan: (cand_d, cand_p, dump). ``nlists``
    candidate lists of kk a query, (nq, nlists, kk), when kk <=
    ``list_k``; else the wide path's distance of every candidate, (nq,
    pool). The scratch a call does not use is empty."""
    f32, i32 = (dict(dtype=dt, device=device)
                for dt in (torch.float32, torch.int32))
    if kk <= list_k:
        return (torch.empty((nq, nlists, kk), **f32),
                torch.empty((nq, nlists, kk), **i32),
                torch.empty((0,), **f32))
    return (torch.empty((0,), **f32), torch.empty((0,), **i32),
            torch.empty((nq, pool), **f32))


def event_handles(marks, n: int):
    """The cudaEvent_t handles of ``marks`` (n ``torch.cuda.Event``s, or
    None) as a ctypes array for a segment scan's launcher, which records
    them between its launches; None passes a null pointer. Each event is
    recorded here once so that its handle exists."""
    if marks is None:
        return None
    if len(marks) != n:
        raise ValueError(f"marks takes {n} events, got {len(marks)}")
    for ev in marks:
        ev.record()
    return (ctypes.c_void_p * n)(*(ctypes.c_void_p(ev.cuda_event)
                                   for ev in marks))


def check_tensor(name, x, dtype, ndim, device):
    """A kernel wrapper's input check: device, dtype, rank, contiguity."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_n_sm: dict = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(n: int, mult: int) -> int:
    return n + (-n) % mult


def pad_axis(x: torch.Tensor, target: int, axis: int, value=0.0):
    """Pad ``x`` along ``axis`` up to length ``target`` with ``value``
    (no-op when already there)."""
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def pick_block(n: int, block: int, mult: int) -> int:
    """Row-tile size: the configured ``block`` when ``n`` fills it,
    else all of ``n`` rounded up to ``mult`` (a single tile)."""
    return block if n >= block else round_up(n, mult)


def map_query_chunks(fn, arrays, block: int, kk: int):
    """Run a per-chunk (dists, ids) scan over ``block``-row chunks of the
    query-row arrays and concatenate: the plain segment scans' way of
    keeping their gathered (block, nprobe, cap, ...) intermediates
    bounded (the reference's ``lax.map`` over chunks)."""
    n = arrays[0].shape[0]
    outs = [fn(*(a[s:s + block] for a in arrays)) for s in range(0, n, block)]
    if not outs:
        return (torch.zeros((0, kk), dtype=torch.float32),
                torch.zeros((0, kk), dtype=torch.int32))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def finish_segment_scan(d: torch.Tensor, ids: torch.Tensor):
    """A segment-scan kernel's output, in (distance, position) order, as
    the reference presents it: candidates at the BIG sentinel are pad
    slots and report id -1, then the final (distance, id) sort."""
    ids = torch.where(d >= BIG, torch.full_like(ids, -1), ids)
    return sort_by_distance_id(d, ids)


def sort_by_distance_id(d: torch.Tensor, ids: torch.Tensor):
    """Sort each row lexicographically by (distance, id): the final
    presentation of every scan path (``lax.sort(..., num_keys=2)``)."""
    by_id = torch.sort(ids, dim=-1, stable=True).indices      # minor key
    d, ids = torch.gather(d, -1, by_id), torch.gather(ids, -1, by_id)
    by_d = torch.sort(d, dim=-1, stable=True).indices         # major key
    return torch.gather(d, -1, by_d), torch.gather(ids, -1, by_d)


def topk_by_distance(d: torch.Tensor, ids: torch.Tensor, k_top: int):
    """Top-k candidates by distance with a deterministic presentation.

    Selects the ``k_top`` smallest distances with a stable sort (ties
    toward the earlier candidate *position*, as ``lax.top_k``), then
    re-sorts the survivors lexicographically by (distance, id) so
    equal-distance neighbors come back smallest-id-first.
    """
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k_top]
    return sort_by_distance_id(torch.gather(d, -1, order),
                               torch.gather(ids, -1, order))
