"""ctypes wrapper of the hand-written Hopper kernel ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``:
causal / sliding-window GQA attention forward, bf16 on the tensor cores
or full f32, any T and S (the kernel masks its ragged edges), Dh any
multiple of 16 up to 128, and 256 (gemma-7b). q, k and v are read in the model's (B, T, H,
Dh) layout through their strides, so no transpose is made. The kernel is
forward-only, as the TPU kernel is: an input that requires grad raises.
The library is built on first use (``kernels/_build.py``); nothing here
touches CUDA at import time. The wrapper checks its inputs before it
builds or launches anything, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, raises on a
non-zero ``cudaError_t``, and counts its launches in
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BLOCK_Q = 64            # query rows of a block
BLOCK_K = 64            # keys of a kv tile
# head dims the kernel is built for: every config's (zamba2 80, gemma 256,
# the others 64 or 128) and the reduced configs'
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 256)
# stride step (elements) and base alignment (bytes) of the kernel's loads:
# 16-byte vectors for bf16, scalars for f32
_ALIGN = {torch.bfloat16: (8, 16), torch.float32: (1, 4)}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 6 + [ll] * 12 + [i, i, ctypes.c_float, i, p])
        lib.flash_attention_launch.restype = i
        for name in ("block_q", "block_k"):
            getattr(lib, f"flash_attention_{name}").restype = i
        if (lib.flash_attention_block_q(),
                lib.flash_attention_block_k()) != (BLOCK_Q, BLOCK_K):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tile sizes")
        _lib = lib
    return _lib


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
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,T,H,Dh), k/v (B,S,K,Dh) on the card, bf16 or f32, H % K == 0
    -> (B,T,H,Dh) in q's dtype. Scores are scaled by 1/sqrt(Dh); key s is
    seen by row t when s <= t (causal) and s > t - window (window > 0)."""
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
    if window and T - window >= S:
        raise ValueError(f"rows past S + window - 1 = {S + window - 1} "
                         f"would see no key (T={T})")
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
            float(1.0 / np.sqrt(dh)), int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
