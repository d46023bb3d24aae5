"""ctypes wrapper of the hand-written Hopper kernel ``csrc/ssd_chunk.cu``.

Counterpart of ``repro/kernels/ssd_chunk/kernel.py::ssd_scan``: the
Mamba2 SSD scan over B x H panes, f32 arithmetic on bf16 or f32 x, B, C,
any T (the kernel zero-fills a ragged last chunk), p <= 128, n <= 64.
The kernel is segment-parallel over T: ``segment_plan`` cuts T into
segments of whole chunks, a state pass writes each segment's end state
from a zero start and the scan pass runs every segment from its combined
start state (``ref.ssd_scan_segmented`` is the same order of work in
plain torch). Inputs are read through their strides: a (B, H, T, p) view
of the model's (B, T, H, p) activations, B and C expanded over heads
with a head stride of 0 (a block then takes two heads and computes C B^T
once for both; B and C with their own head stride take one head a
block). The kernel is forward-only, as the TPU kernel is: an input that
requires grad raises. The library is built on first use
(``kernels/_build.py``); nothing here touches CUDA at import time. The
wrapper checks its inputs before it builds or launches anything,
allocates the outputs and the state pass's scratch with ``torch.empty``,
launches on the current stream without synchronising, raises on a
non-zero ``cudaError_t``, and counts its calls in ``ssd_scan.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import cdiv
from repro_torch.kernels.ssd_chunk.ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
MAX_P, MAX_N = 128, 64
HEADS_PER_BLOCK = 2         # one head a warpgroup, sharing C B^T
MAX_SEGMENTS = 32           # the scan blocks combine up to 31 end states
MIN_SEGMENT_CHUNKS = 4
TARGET_BLOCKS = 4 * 132     # four blocks per SM of an H100 SXM


def segment_plan(B: int, H: int, T: int, shared_bc: bool = True):
    """(chunks_per_segment, heads_per_block, grid) of the kernel's scan
    pass. Heads go two a block when B and C are shared by the heads
    (``shared_bc``), else one. T's chunks are cut into the fewest
    segments of at least ``MIN_SEGMENT_CHUNKS`` chunks that give
    ``TARGET_BLOCKS`` blocks, at most ``MAX_SEGMENTS``; a short T or a
    large B x H stays one segment. grid = (segments, head groups, B):
    the scan pass launches their product, the state pass B x groups x
    (segments - 1)."""
    chunks = cdiv(T, CHUNK)
    hpb = HEADS_PER_BLOCK if shared_bc else 1
    groups = cdiv(H, hpb)
    want = cdiv(TARGET_BLOCKS, B * groups)
    segs = max(1, min(want, chunks // MIN_SEGMENT_CHUNKS, MAX_SEGMENTS))
    cps = cdiv(chunks, segs)
    return cps, hpb, (cdiv(chunks, cps), groups, B)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_launch.argtypes = [p] * 9 + [i] * 7 + [ll] * 18 + [i, p]
        lib.ssd_scan_launch.restype = i
        names = ("length", "max_p", "max_n", "heads_per_block",
                 "max_segments")
        for name in names:
            getattr(lib, f"ssd_chunk_{name}").restype = i
        if tuple(getattr(lib, f"ssd_chunk_{name}")() for name in names) != (
                CHUNK, MAX_P, MAX_N, HEADS_PER_BLOCK, MAX_SEGMENTS):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"chunk or tile sizes")
        _lib = lib
    return _lib


def _check(name, x, dtype, ndim, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(x.shape)}")
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel is forward-only")


def ssd_scan(xs: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, la: torch.Tensor,
             chunks_per_segment: int | None = None):
    """The SSD scan on the card over B x H panes: xs (B,H,T,p), Bm/Cm
    (B,H,T,n), dt/la (B,H,T); any strides, the last axis of xs, Bm and
    Cm contiguous; xs, Bm and Cm bf16 or f32 alike, dt and la f32.
    ``chunks_per_segment`` overrides ``segment_plan``'s (at most
    ``MAX_SEGMENTS`` segments). Returns (y (B,H,T,p) in xs's dtype,
    h_final (B,H,p,n) f32). y is a view of (B,T,H,p) memory, so
    ``y.transpose(1, 2)`` is the model's contiguous layout."""
    device = xs.device
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA tensors, got {device}")
    if xs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"xs must be bfloat16 or float32, got {xs.dtype}")
    _check("xs", xs, xs.dtype, 4, device)
    for name, x in (("Bm", Bm), ("Cm", Cm)):
        _check(name, x, xs.dtype, 4, device)
    for name, x in (("dt", dt), ("la", la)):
        _check(name, x, torch.float32, 3, device)
    B, H, T, p = xs.shape
    n = Bm.shape[-1]
    if tuple(Bm.shape) != (B, H, T, n) or tuple(Cm.shape) != (B, H, T, n) \
            or tuple(dt.shape) != (B, H, T) or tuple(la.shape) != (B, H, T):
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, dt "
                         f"{tuple(dt.shape)}, la {tuple(la.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"p={p}, n={n}: the kernel takes p <= {MAX_P}, "
                         f"n <= {MAX_N}")
    for name, x in (("xs", xs), ("Bm", Bm), ("Cm", Cm)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    y = torch.empty((B, T, H, p), dtype=xs.dtype,
                    device=device).transpose(1, 2)
    hf = torch.empty((B, H, p, n), dtype=torch.float32, device=device)
    if B * H == 0 or T == 0:
        return y, hf.zero_()
    shared = Bm.stride(1) == 0 and Cm.stride(1) == 0
    cps, hpb, (segs, _, _) = segment_plan(B, H, T, shared)
    if chunks_per_segment is not None:
        cps = chunks_per_segment
        segs = cdiv(cdiv(T, CHUNK), max(cps, 1))
        if cps < 1 or segs > MAX_SEGMENTS:
            raise ValueError(f"chunks_per_segment={cps} gives {segs} "
                             f"segments; the kernel takes 1..{MAX_SEGMENTS}")
    # the state pass's end states and log decays, segments 0 .. S - 2
    es = torch.empty((B * H * (segs - 1) * p * n,), dtype=torch.float32,
                     device=device)
    lam = torch.empty((B * H * (segs - 1),), dtype=torch.float32,
                      device=device)
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    strides = [s for x in (xs, Bm, Cm, dt, la, y) for s in x.stride()[:3]]
    with torch.cuda.device(device):
        err = lib.ssd_scan_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (xs, Bm, Cm, dt, la, y,
                                                       hf, es, lam)),
            B, H, T, p, n, cps, hpb, *strides,
            int(xs.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t "
                           f"{err}")
    ssd_scan.launches += 1
    return y, hf


ssd_scan.launches = 0
