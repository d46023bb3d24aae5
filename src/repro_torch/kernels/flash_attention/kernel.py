"""ctypes wrapper of the hand-written Hopper kernel ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``:
causal / sliding-window GQA attention forward, bf16 on the tensor cores
or full f32, any T and S (the kernel masks its ragged edges), Dh any
multiple of 16 up to 128, and 256 (gemma-7b). q, k and v are read in the
model's (B, T, H, Dh) layout through their strides, so no transpose is
made. ``q_offset`` places q's rows at positions ``q_offset ..``: one
rank's slice of a longer query sequence under context parallelism
(``models/attention.apply_rank``), against the keys from position 0.
bf16 runs ``flash_wgmma``: 128-row q tiles (two warpgroups), k and v
tiles of ``block_k(Dh)`` keys brought in by TMA, both products on
``wgmma``; f32 runs ``flash_f32`` (FFMA, 64-row tiles). ``tile_plan`` is
the bf16 kernel's sorting of kv tiles into skipped, edge and full ones,
in plain Python for the CPU tests. The kernel is forward-only, as the
TPU kernel is: an input that requires grad raises. The library is built
on first use (``kernels/_build.py``); nothing here touches CUDA at
import time. The wrapper checks its inputs before it builds or launches
anything, allocates the output with ``torch.empty``, launches on the
current stream without synchronising, raises on a non-zero
``cudaError_t``, and counts its launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BLOCK_Q = 128           # query rows of a bf16 block (two warpgroups)
# head dims the kernel is built for: every config's (zamba2 80, gemma 256,
# the others 64 or 128) and the reduced configs'
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 256)
# a bf16 kv tile's kinds in tile_plan
SKIP, EDGE, FULL = 0, 1, 2
# stride step (elements) and base alignment (bytes) of the kernel's loads:
# 16-byte TMA rows for bf16, scalars for f32
_ALIGN = {torch.bfloat16: (8, 16), torch.float32: (1, 4)}

_lib = None


def block_k(dh: int) -> int:
    """Keys of a bf16 kv tile: 128, or 80 at Dh 256 (o alone takes 128
    registers a thread there, and q + two k/v slots 224 KB)."""
    return 80 if dh > 128 else 128


def tile_plan(T: int, S: int, causal: bool, window: int, dh: int,
              q_offset: int = 0) -> np.ndarray:
    """(q tiles, kv tiles) int8 array of the bf16 kernel's kinds for
    rows in blocks of BLOCK_Q (row t at position t + q_offset) and keys
    in blocks of ``block_k(dh)``: SKIP (no allowed (t, s) pair; never
    visited), FULL (every pair of rows < T allowed; no mask) or EDGE
    (masked score by score). Mirrors ``kv_tiles`` and ``full_tile`` of
    the CUDA source; the card tests hold it to ``kernel_tile_plan``,
    which runs those."""
    bq, bk = BLOCK_Q, block_k(dh)
    plan = np.full((-(-T // bq), -(-S // bk)), SKIP, np.int8)
    for qt in range(plan.shape[0]):
        p0 = qt * bq + q_offset
        p_last = min(qt * bq + bq, T) - 1 + q_offset
        lo = max(0, p0 - window + 1) if window > 0 else 0
        hi = min(S, p_last + 1) if causal else S
        j1 = -(-hi // bk) if hi > lo else lo // bk
        for j in range(lo // bk, j1):
            s0, s_last = j * bk, j * bk + bk - 1
            full = (s_last < S and (not causal or s_last <= p0)
                    and (window == 0 or s0 > p_last - window))
            plan[qt, j] = FULL if full else EDGE
    return plan


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 6 + [ll] * 12 + [i, i, i, ctypes.c_float, i, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_tile_plan.argtypes = [i] * 8 + [p]
        lib.flash_attention_tile_plan.restype = i
        _lib = lib
    return _lib


def kernel_tile_plan(T: int, S: int, causal: bool, window: int, dh: int,
                     q_offset: int = 0) -> np.ndarray:
    """``tile_plan``'s array as the CUDA source's own ``kv_tiles`` and
    ``full_tile`` compute it, on the host (the library is built, no card
    is used). Raises when the source's tiling of T and S is not
    ``tile_plan``'s."""
    plan = np.full((-(-T // BLOCK_Q), -(-S // block_k(dh))), -1, np.int8)
    err = _library().flash_attention_tile_plan(
        T, S, int(causal), window, q_offset, dh, *plan.shape,
        ctypes.c_void_p(plan.ctypes.data))
    if err != 0:
        raise RuntimeError(f"{SOURCE} refused a tile plan of shape "
                           f"{plan.shape} for T={T}, S={S}, Dh={dh}: "
                           f"cudaError_t {err}")
    return plan


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} like q, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} must be 4-D, got {tuple(x.shape)}")
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel is forward-only")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}'s last axis must be contiguous")
    step, base = _ALIGN[dtype]
    if any(s % step for s in x.stride()[:3]) or x.data_ptr() % base:
        raise ValueError(f"{name} must start {base}-byte aligned with "
                         f"strides that are multiples of {step} elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,T,H,Dh), k/v (B,S,K,Dh) on the card, bf16 or f32, H % K == 0
    -> (B,T,H,Dh) in q's dtype. Scores are scaled by 1/sqrt(Dh); row t
    sits at position t + q_offset, and key s is seen by it when
    s <= t + q_offset (causal) and s > t + q_offset - window (window >
    0)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got "
                         f"{device}")
    if q.dtype not in _ALIGN:
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.dtype, device)
    B, T, H, dh = q.shape
    S, K = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or \
            k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} is not one of {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window and T + q_offset - window >= S:
        raise ValueError(f"positions past S + window - 1 = {S + window - 1} "
                         f"would see no key (T={T}, q_offset={q_offset})")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B} or H={H} exceeds the grid's 65535")
    out = torch.empty((B, T, H, dh), dtype=q.dtype, device=device)
    if B == 0 or T == 0 or S == 0:
        return out
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3]]
    with torch.cuda.device(device):
        err = lib.flash_attention_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, out)),
            B, T, S, H, K, dh, *strides, int(causal), int(window),
            int(q_offset), float(1.0 / np.sqrt(dh)), int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
