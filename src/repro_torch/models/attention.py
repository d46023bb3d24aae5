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
  * ``apply_rank`` / ``decode_attend_rank`` — one rank's attention on a
                         live mesh (``common.Ranks``), at the reference's
                         ``constrain`` points: weights all-gathered over
                         ``data`` (FSDP), q / k / v column-parallel on this
                         rank's heads and ``wo`` row-parallel (a partial
                         over ``model``). kv heads that do not divide
                         ``model`` are replicated, and a rank keeps the
                         ones its q heads read. q heads that do not divide
                         it take context parallelism instead: each rank
                         its slice of every q chunk against the whole k
                         and v (on the card one ``flash_attention``
                         launch a slice, at the slice's ``q_offset``).
                         A decode cache sharded over its sequence
                         (``cache_seq``) is attended a slice a rank and
                         the partial softmax merged over ``model``.

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
from repro_torch.sharding import partition

CHUNKED_THRESHOLD = 2048    # attend_plain's switch from naive to chunked


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


def _proj_q(w, x, qpos, cfg: ArchConfig):
    """x (B,T,d) -> q (B,T,H,Dh) at positions ``qpos``: bias, QK-norm,
    RoPE."""
    q = _heads(x, w["wq"])
    if cfg.attn_bias:
        q = q + w["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = _rms(q, w["q_norm"])
    return common.apply_rope(q, qpos, cfg.rope_theta)


def _proj_kv(w, x, positions, cfg: ArchConfig):
    """x (B,T,d) -> k, v (B,T,K,Dh): biases, QK-norm and RoPE on k."""
    k, v = _heads(x, w["wk"]), _heads(x, w["wv"])
    if cfg.attn_bias:
        k = k + w["bk"].to(x.dtype)
        v = v + w["bv"].to(x.dtype)
    if cfg.qk_norm:
        k = _rms(k, w["k_norm"])
    return common.apply_rope(k, positions, cfg.rope_theta), v


def qkv_proj(p, x, positions, cfg: ArchConfig):
    """x (B,T,d) -> q (B,T,H,Dh), k/v (B,T,K,Dh), RoPE applied."""
    k, v = _proj_kv(p, x, positions, cfg)
    return _proj_q(p, x, positions, cfg), k, v


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


def _stream(qblk, qpos, k, v, cfg: ArchConfig, kv_chunk: int):
    """One q block's streaming attention over k / v in chunks of
    ``kv_chunk``. qblk (B,qc,K,G,Dh) at positions ``qpos``; returns
    (B,qc,H,Dh) in qblk's dtype."""
    B, qc, K, G, dh = qblk.shape
    S = k.shape[1]
    scale = float(1.0 / np.sqrt(dh))
    m = torch.full((B, K, G, qc), NEG_INF, device=qblk.device)
    l = torch.zeros((B, K, G, qc), device=qblk.device)
    acc = torch.zeros((B, K, G, qc, dh), device=qblk.device)
    for kj in range(S // kv_chunk):
        kblk = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
        vblk = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk) * scale
        s = s.to(torch.float32)                          # (B,K,G,qc,kc)
        kpos = kj * kv_chunk + torch.arange(kv_chunk, device=qblk.device)
        s = torch.where(_mask(qpos, kpos, cfg), s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + torch.sum(p, dim=-1)
        acc = corr[..., None] * acc + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(qblk.dtype), vblk).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # (B,K,G,qc,Dh) -> (B,qc,H,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, qc, K * G, dh) \
        .to(qblk.dtype)


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
    qg = _group_q(q, K)
    outs = []
    for qi in range(T // q_chunk):
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        outs.append(_stream(qg[:, qi * q_chunk:(qi + 1) * q_chunk], qpos,
                            k, v, cfg, kv_chunk))
    return torch.cat(outs, dim=1)


def attend_plain(q, k, v, cfg: ArchConfig,
                 chunked_threshold: int = CHUNKED_THRESHOLD):
    """The reference's ``attend``: naive up to ``chunked_threshold``
    positions, chunked above."""
    if q.shape[1] <= chunked_threshold:
        return attend_naive(q, k, v, cfg)
    return attend_chunked(q, k, v, cfg, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk)


def _kernel_window(cfg: ArchConfig) -> int:
    return cfg.window if cfg.attention == "sliding" else 0


def attend(q, k, v, cfg: ArchConfig):
    """Full-sequence attention: the flash attention kernel on the card,
    the plain forms on the CPU."""
    if not q.is_cuda:
        return attend_plain(q, k, v, cfg)
    return flash_attention(q, k, v, causal=cfg.causal,
                           window=_kernel_window(cfg))


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------

def cache_axes(n_kv: int, mesh) -> tuple:
    """Logical axes of a KV cache (B, S, K, Dh) on ``mesh``: the kv heads
    over ``model`` where they divide it, else the cache's sequence
    (flash-decoding's partial softmax)."""
    if n_kv % mesh.shape["model"] == 0:
        return ("batch", None, "kv_heads", None)
    return ("batch", "cache_seq", None, None)


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
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q = _proj_q(p, x, positions, cfg)
    k_new, v_new = _proj_kv(p, x, positions, cfg)
    cache = cache_update(cache, k_new, v_new, pos, cfg)
    S = cache.k.shape[1]
    ctx = _attend_slots(q, cache.k, cache.v, pos, cfg,
                        torch.arange(S, device=x.device), S)
    return out_proj(p, ctx, cfg), cache


# --------------------------------------------------------------------------
# The per-rank program on a live mesh
# --------------------------------------------------------------------------

def _kv_for(h0: int, Hl: int, cfg: ArchConfig):
    """The kv heads that q heads [h0, h0 + Hl) read: a slice when they
    group contiguously and evenly, else one kv head a q head (an index
    tensor)."""
    G = cfg.n_heads // cfg.kv_heads
    ids = [(h0 + i) // G for i in range(Hl)]
    lo, hi = ids[0], ids[-1] + 1
    per = Hl // (hi - lo)
    if Hl % (hi - lo) == 0 and all(ids[i] - lo == i // per
                                   for i in range(Hl)):
        return slice(lo, hi)
    return torch.tensor(ids)


def _rank_weights(p, s, cfg: ArchConfig, ranks):
    """This rank's attention weights, FSDP-gathered: (w, h0, kv), where w
    holds wq / wo (and bq) on its q heads [h0, h0 + Hl), wk / wv (and bk,
    bv) on its kv heads, and bo, q_norm, k_norm. kv is None when the kv
    heads are this rank's block (or all of them), else the cut of the
    replicated kv heads that its q heads read (``_kv_for``)."""
    Hl = p["wq"].shape[1]
    h0 = ranks.m * Hl if ranks.on_model(s["wq"], 1) else 0
    kv = None
    if not ranks.on_model(s["wk"], 1) and Hl < cfg.n_heads:
        kv = _kv_for(h0, Hl, cfg)
    w = {}
    for name in p:
        t = p[name]
        if kv is not None and name in ("wk", "wv"):
            t = t[:, kv]
        elif kv is not None and name in ("bk", "bv"):
            t = t[kv]
        w[name] = ranks.gather(t, s[name])
    return w, h0, kv


def _cp_rows(T: int, cfg: ArchConfig, M: int):
    """Context parallelism's split of T: (q chunk, chunks, rows a rank
    takes of each), the chunk the plain path's (T itself up to the
    chunked threshold); None when a chunk does not divide ``M``."""
    qc = T if T <= CHUNKED_THRESHOLD else min(cfg.attn_q_chunk, T)
    if T % qc or qc % M:
        return None
    return qc, T // qc, qc // M


def cp_offsets(cp, m: int):
    """The positions of model rank ``m``'s first row in each q chunk of
    the split ``cp`` (``_cp_rows``): its slices' ``q_offset``."""
    qc, nq, rows = cp
    return [c * qc + m * rows for c in range(nq)]


def apply_rank(p, s, x, positions, cfg: ArchConfig, ranks, plain: bool):
    """One rank's attention of the whole-sequence ``x`` (B,T,d), its
    weights this rank's blocks of the specs ``s``: (y, kind) for
    ``Ranks.reduce``. Heads over ``model``: y (B,T,d) is a ``"partial"``
    of the row-parallel ``wo``. Heads that do not divide ``model``:
    context parallelism, each rank its slice of every q chunk (the
    reference's ``attend_chunked``; the naive path is one chunk) against
    the whole k and v; y is ``"sp"`` (one chunk: the slice is the rank's
    residual rows) or gathered ``"full"``. On the card (not ``plain``)
    each slice is one ``flash_attention`` launch at its position
    (``cp_offsets``), against every key: a causal slice's keys past its
    last position lie in tiles the kernel never visits. Attention
    biases (hubert) come as this rank's blocks of ``bq`` / ``bk`` /
    ``bv``; ``bo`` is added once over ``model`` (``Ranks.bias``)."""
    w, _, _ = _rank_weights(p, s, cfg, ranks)
    T = x.shape[1]
    heads_split = ranks.on_model(s["wq"], 1)
    cp = None if heads_split or not ranks.model else \
        _cp_rows(T, cfg, ranks.M)
    k, v = _proj_kv(w, x, positions, cfg)
    if cp is None:
        q = _proj_q(w, x, positions, cfg)
        ctx = (attend_plain if plain else attend)(q, k, v, cfg)
        kind = "partial" if heads_split else "full"
        return _out_rank(w, ctx, ranks, kind), kind
    qc, nq, rows = cp

    def pick(t):        # this rank's rows of every q chunk
        return t.unflatten(1, (nq, ranks.M, rows))[:, :, ranks.m] \
            .flatten(1, 2)

    q = _proj_q(w, pick(x), pick(positions), cfg)
    outs = []
    for c, off in enumerate(cp_offsets(cp, ranks.m)):
        qb = q[:, c * rows:(c + 1) * rows]
        if x.is_cuda and not plain:
            outs.append(flash_attention(qb, k, v, causal=cfg.causal,
                                        window=_kernel_window(cfg),
                                        q_offset=off))
        elif nq == 1:
            outs.append(attend_naive(qb, k, v, cfg, q_offset=off))
        else:
            qpos = off + torch.arange(rows, device=x.device)
            outs.append(_stream(_group_q(qb, k.shape[2]), qpos, k, v, cfg,
                                min(cfg.attn_kv_chunk, T)))
    y = _out_rank(w, torch.cat(outs, dim=1), ranks, "full")
    if nq == 1:
        return y, "sp"
    # every rank's rows, back in sequence order
    y = partition.all_gather(y, "model", ranks.mesh, axis=1, tiled=True)
    return y.unflatten(1, (ranks.M, nq, rows)).transpose(1, 2) \
        .flatten(1, 3), "full"


def _out_rank(w, ctx, ranks, kind: str):
    B, T, H, dh = ctx.shape
    y = ctx.reshape(B, T, H * dh) @ w["wo"].reshape(H * dh, -1).to(ctx.dtype)
    return ranks.bias(y, w["bo"], kind) if "bo" in w else y


def decode_attend_rank(p, s, cs, x, cache: KVCache, pos: int,
                       cfg: ArchConfig, ranks):
    """One rank's decode attention: x (B,1,d) the same on every ``model``
    rank, ``cache`` this rank's block of the specs ``cs`` (written in
    place). Returns (y, kind, cache). A cache over kv heads attends this
    rank's heads (a replicated one the kv heads its q heads read, every
    kv head written); one over its sequence (``cache_seq``: the kv heads
    do not divide ``model``) attends this rank's slice of the slots for
    every head, the owner of ``pos``'s slot writes it, and the partial
    softmax (max, sum, p v) is merged over ``model`` by the log-sum-exp
    rule."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    heads_split = ranks.on_model(s["wq"], 1)
    kind = "partial" if heads_split else "full"
    if not ranks.on_model(cs.k, 1):
        w, h0, kv = _rank_weights(p, s, cfg, ranks)
        q = _proj_q(w, x, positions, cfg)
        if kv is None:
            k_new, v_new = _proj_kv(w, x, positions, cfg)
        else:               # the replicated cache keeps every kv head
            k_new, v_new = _proj_kv(
                {n: ranks.gather(p[n], s[n]) for n in p}, x, positions, cfg)
        cache = cache_update(cache, k_new, v_new, pos, cfg)
        ck, cv = (cache.k, cache.v) if kv is None else \
            (cache.k[:, :, kv], cache.v[:, :, kv])
        S = ck.shape[1]
        ctx = _attend_slots(q, ck, cv, pos, cfg,
                            torch.arange(S, device=x.device), S)
        return _out_rank(w, ctx, ranks, kind), kind, cache
    # the cache over its sequence: every kv head, this rank's slots
    S_l = cache.k.shape[1]
    S = S_l * ranks.M
    w = {n: ranks.gather(p[n], s[n]) for n in p}
    q = _proj_q(w, x, positions, cfg)
    Hl = q.shape[2]
    if heads_split:                         # every head's query
        q = partition.all_gather(q, "model", ranks.mesh, axis=2, tiled=True)
    k_new, v_new = _proj_kv(w, x, positions, cfg)
    slot = pos % S
    if slot // S_l == ranks.m:
        cache.k[:, slot - ranks.m * S_l] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot - ranks.m * S_l] = v_new[:, 0].to(cache.v.dtype)
    slots = ranks.m * S_l + torch.arange(S_l, device=x.device)
    m, l, acc = _attend_slots(q, cache.k, cache.v, pos, cfg, slots, S,
                              partial=True)
    m_all = partition.pmax(m, "model", ranks.mesh)
    corr = torch.exp(m - m_all)
    l, acc = partition.psum((l * corr, acc * corr[..., None]), "model",
                            ranks.mesh)
    H, dh = q.shape[2], q.shape[3]
    ctx = (acc / l[..., None]).to(x.dtype)          # (B,K,G,1,Dh)
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(B, 1, H, dh)
    if heads_split:
        ctx = ctx[:, :, ranks.m * Hl:(ranks.m + 1) * Hl]
    return _out_rank(w, ctx, ranks, kind), kind, cache


def _attend_slots(q, ck, cv, pos: int, cfg: ArchConfig, slots, S: int,
                  partial: bool = False):
    """q (B,1,H,Dh) against the cache slots ``slots`` of a ring of ``S``
    (``decode_attend``'s mask and order). Returns ctx (B,1,H,Dh), or
    with ``partial`` the unnormalized (max, sum, p v) in f32 over these
    slots, (B,K,G,1) twice and (B,K,G,1,Dh)."""
    B, _, H, dh = q.shape
    K = ck.shape[2]
    dt = q.dtype
    slot_pos = pos - (pos - slots) % S
    valid = slot_pos >= 0
    if cfg.attention == "sliding":
        valid &= slot_pos > pos - cfg.window
    valid &= slot_pos <= pos
    qg = q.reshape(B, 1, K, H // K, dh)
    scale = float(1.0 / np.sqrt(dh))
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.to(dt)) * scale
    scores = scores.to(torch.float32).masked_fill(~valid, NEG_INF)
    if not partial:
        w = torch.softmax(scores, dim=-1).to(dt)
        ctx = torch.einsum("bkgqs,bskd->bqkgd", w, cv.to(dt))
        return ctx.reshape(B, 1, H, dh)
    m = torch.amax(scores, dim=-1)
    e = torch.exp(scores - m[..., None]).masked_fill(~valid, 0.0)
    acc = torch.einsum("bkgqs,bskd->bkgqd", e.to(dt), cv.to(dt))
    return m, torch.sum(e, dim=-1), acc.to(torch.float32)
