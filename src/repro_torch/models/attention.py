"""GQA/MQA attention with RoPE, optional QK-norm, sliding window and KV
cache (counterpart of ``repro/models/attention.py``).

Execution paths:
  * ``attend_naive``   — materializes (T, S) scores; short sequences.
  * ``attend_chunked`` — flash-style streaming softmax over KV chunks for
                         each q chunk; O(chunk^2) live memory.
  * ``attend_plain``   — the reference's ``attend``: naive up to 2048
                         positions, chunked above. Differentiable; the
                         model's ``plain`` path and the CPU path.
  * ``attend``         — the inference path: the hand-written flash
                         attention kernel on the card
                         (``kernels/flash_attention``), ``attend_plain``
                         on the CPU.
  * ``decode_attend``  — single-token query against a (ring-buffered)
                         cache, plain torch on any device.

Sliding-window caches are ring buffers of ``min(window, max_seq)`` slots,
so long decodes hold O(window), not O(seq), state per layer. The port
writes each step's K/V into the cache in place (the reference returns a
new cache); ``decode_attend`` still returns the cache it wrote.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import common


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, K, Dh)
    v: torch.Tensor       # (B, S_cache, K, Dh)


def init_attention(cfg: ArchConfig, gen) -> dict:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dim_per_head
    p = {"wq": common.he_init(gen, (d, H, dh), d),
         "wk": common.he_init(gen, (d, K, dh), d),
         "wv": common.he_init(gen, (d, K, dh), d),
         "wo": common.he_init(gen, (H, dh, d), H * dh)}
    dev = gen.device
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H, dh), device=dev)
        p["bk"] = torch.zeros((K, dh), device=dev)
        p["bv"] = torch.zeros((K, dh), device=dev)
        p["bo"] = torch.zeros((d,), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), device=dev)
        p["k_norm"] = torch.ones((dh,), device=dev)
    return p


def logical_axes(cfg: ArchConfig) -> dict:
    lg = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.attn_bias:
        lg.update({"bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
                   "bv": ("kv_heads", "head_dim"), "bo": ("embed",)})
    if cfg.qk_norm:
        lg.update({"q_norm": (None,), "k_norm": (None,)})
    return lg


def _rms(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _heads(x, w):
    """x (B,T,d) @ w (d,H,Dh) -> (B,T,H,Dh), contiguous."""
    d, H, dh = w.shape
    return (x @ w.reshape(d, H * dh).to(x.dtype)).reshape(
        x.shape[0], x.shape[1], H, dh)


def qkv_proj(p, x, positions, cfg: ArchConfig):
    """x (B,T,d) -> q (B,T,H,Dh), k/v (B,T,K,Dh), RoPE applied."""
    dt = x.dtype
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"])
        k = _rms(k, p["k_norm"])
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p, ctx, cfg: ArchConfig):
    """ctx (B,T,H,Dh) -> (B,T,d)."""
    B, T, H, dh = ctx.shape
    y = ctx.reshape(B, T, H * dh) @ p["wo"].reshape(H * dh, -1).to(ctx.dtype)
    if cfg.attn_bias:
        y = y + p["bo"].to(ctx.dtype)
    return y


def _group_q(q, n_kv):
    """(B,T,H,Dh) -> (B,T,K,G,Dh) for GQA."""
    B, T, H, dh = q.shape
    return q.reshape(B, T, n_kv, H // n_kv, dh)


def _mask(qpos, kpos, cfg: ArchConfig):
    mask = torch.ones((len(qpos), len(kpos)), dtype=torch.bool,
                      device=qpos.device)
    if cfg.causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if cfg.attention == "sliding":
        mask &= kpos[None, :] > qpos[:, None] - cfg.window
    return mask


def attend_naive(q, k, v, cfg: ArchConfig, q_offset: int = 0):
    """Materialized-scores attention. q (B,T,H,Dh); k,v (B,S,K,Dh)."""
    B, T, H, dh = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = _group_q(q, K)                                 # (B,T,K,G,Dh)
    scale = float(1.0 / np.sqrt(dh))
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
    scores = scores.to(torch.float32)
    mask = _mask(torch.arange(T, device=q.device) + q_offset,
                 torch.arange(S, device=q.device), cfg)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgts,bskd->btkgd", w, v)
    return ctx.reshape(B, T, H, dh)


def attend_chunked(q, k, v, cfg: ArchConfig, q_chunk: int = 1024,
                   kv_chunk: int = 1024):
    """Flash-style streaming attention (self-attention over the full
    sequence). q (B,T,H,Dh), k/v (B,T,K,Dh). Causal and/or sliding-window
    masks per (q chunk, kv chunk) tile; running max / denominator carried
    across kv chunks, so no (T, T) tensor is materialized."""
    B, T, H, dh = q.shape
    K = k.shape[2]
    q_chunk, kv_chunk = min(q_chunk, T), min(kv_chunk, T)
    if T % q_chunk or T % kv_chunk:
        raise ValueError(f"T={T} is not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    nq, nk = T // q_chunk, T // kv_chunk
    scale = float(1.0 / np.sqrt(dh))
    G = H // K
    qg = _group_q(q, K)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]          # (B,qc,K,G,Dh)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, K, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, q_chunk), device=q.device)
        acc = torch.zeros((B, K, G, q_chunk, dh), device=q.device)
        for kj in range(nk):
            kblk = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vblk = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk) * scale
            s = s.to(torch.float32)                          # (B,K,G,qc,kc)
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
            s = torch.where(_mask(qpos, kpos, cfg), s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + torch.sum(p, dim=-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(q.dtype), vblk).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        # (B,K,G,qc,Dh) -> (B,qc,H,Dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, dh)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attend_plain(q, k, v, cfg: ArchConfig, chunked_threshold: int = 2048):
    """The reference's ``attend``: naive up to ``chunked_threshold``
    positions, chunked above."""
    if q.shape[1] <= chunked_threshold:
        return attend_naive(q, k, v, cfg)
    return attend_chunked(q, k, v, cfg, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk)


def attend(q, k, v, cfg: ArchConfig):
    """Full-sequence attention: the flash attention kernel on the card,
    the plain forms on the CPU."""
    if not q.is_cuda:
        return attend_plain(q, k, v, cfg)
    return flash_attention(q, k, v, causal=cfg.causal,
                           window=cfg.window if cfg.attention == "sliding"
                           else 0)


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, max_seq: int) -> int:
    return min(cfg.window, max_seq) if cfg.attention == "sliding" else max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    S = cache_len(cfg, max_seq)
    K, dh = cfg.kv_heads, cfg.dim_per_head
    return KVCache(k=torch.zeros((batch, S, K, dh), dtype=dtype,
                                 device=device),
                   v=torch.zeros((batch, S, K, dh), dtype=dtype,
                                 device=device))


def cache_update(cache: KVCache, k_new, v_new, pos: int,
                 cfg: ArchConfig) -> KVCache:
    """Write one step's K/V (B,1,K,Dh) at position ``pos`` (ring-buffered
    modulo the cache length for sliding windows), in place; returns the
    cache."""
    slot = pos % cache.k.shape[1]
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    return cache


def decode_attend(p, x, cache: KVCache, pos: int, cfg: ArchConfig):
    """One-token attention. x (B,1,d); ``pos`` a Python int (the position
    of the new token, so no host sync enters the loop). Returns (out
    (B,1,d), the cache, written in place). q, k, v and the scores run in
    x's dtype; the scores go to f32 after the scale, are masked with
    -1e30 and take an f32 softmax, whose weights are cast back before
    p v — the reference's order."""
    B = x.shape[0]
    dt = x.dtype
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _heads(x, p["wq"]), _heads(x, p["wk"]), \
        _heads(x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"].to(dt)
        k_new = k_new + p["bk"].to(dt)
        v_new = v_new + p["bv"].to(dt)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"])
        k_new = _rms(k_new, p["k_norm"])
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k_new = common.apply_rope(k_new, positions, cfg.rope_theta)

    cache = cache_update(cache, k_new, v_new, pos, cfg)
    S, K = cache.k.shape[1], cache.k.shape[2]
    H, dh = q.shape[2], q.shape[3]

    # position held by each ring slot: largest p <= pos with p % S == slot
    # (torch's % takes the divisor's sign, as jnp's does)
    slot_pos = pos - (pos - torch.arange(S, device=x.device)) % S
    valid = slot_pos >= 0
    if cfg.attention == "sliding":
        valid &= slot_pos > pos - cfg.window
    valid &= slot_pos <= pos

    qg = q.reshape(B, 1, K, H // K, dh)
    scale = float(1.0 / np.sqrt(dh))
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, cache.k.to(dt)) * scale
    scores = scores.to(torch.float32)
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", w, cache.v.to(dt))
    out = out_proj(p, ctx.reshape(B, 1, H, dh), cfg)
    return out, cache
