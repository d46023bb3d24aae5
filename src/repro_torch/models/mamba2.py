"""Mamba2 (SSD — state-space duality) block (counterpart of
``repro/models/mamba2.py``).

Recurrence per head h (head_dim p, state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T        (h: (p, n))
    y_t = h_t C_t + D * x_t

Three forms of the same function:
  * ``apply_mamba2``        — the chunked form in plain torch (the
                              reference's training / prefill form, its
                              O(Q^2) tiles in ``cfg.ssm_tile_dtype``);
                              kept for the training slice.
  * ``apply_mamba2_kernel`` — the inference / prefill path: the SSD core
                              through ``kernels/ssd_chunk`` (the
                              hand-written kernel on the card, its plain
                              chunked version on the CPU). Forward-only.
  * ``apply_mamba2_ref``    — the exact token-by-token recurrence (the
                              tests' oracle).

Decode is the exact single-step recurrence (``decode_step``) over a
``MambaCache``: the f32 state ``h`` and the causal conv's last W-1
inputs in the activation dtype.

On a live mesh (``common.Ranks``) a rank runs its block of the heads:
``apply_mamba2_rank`` (either form) and ``decode_step_rank`` take the
rank's columns of ``w_z``, ``w_dt``, ``w_out`` and of the replicated
vectors, and of ``w_xbc`` its heads' ``xs`` columns and all of B and C:
``w_xbc``'s block over ``model`` does not fall on heads (conv_ch = d_in
+ 2n), so the weight is gathered whole (its backward a reduce-scatter
that gives each rank's block its gradient). The forms read their head
count from the weights they are given; the gated RMSNorm sums its
squares over every head (one all-reduce over ``model``), and ``w_out``
is row-parallel: the output is a partial.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._dispatch import full_f32
from repro_torch.kernels.ssd_chunk import ssd_core
from repro_torch.models import common
from repro_torch.sharding import partition


class MambaCache(NamedTuple):
    h: torch.Tensor        # (B, H, p, n) SSM state, f32
    conv: torch.Tensor     # (B, W-1, conv_channels) causal-conv history


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads
    p = d_in // H
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n
    return d_in, H, p, n, conv_ch


def init_mamba2(cfg: ArchConfig, gen) -> dict:
    d = cfg.d_model
    d_in, H, p, n, conv_ch = _dims(cfg)
    dev = gen.device
    w_z = common.he_init(gen, (d, d_in), d)
    w_xbc = common.he_init(gen, (d, conv_ch), d)
    w_dt = common.he_init(gen, (d, H), d)
    conv_w = 0.1 * common.randn(gen, (cfg.conv_width, conv_ch))
    w_out = common.he_init(gen, (d_in, d), d_in)
    u = common.rand(gen, (H,))
    dt = torch.exp(np.log(1e-3) + u * (np.log(1e-1) - np.log(1e-3)))
    return {
        "w_z": w_z, "w_xbc": w_xbc, "w_dt": w_dt, "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),              # softplus inverse
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((H,), device=dev),
        "norm_scale": torch.ones((d_in,), device=dev),
        "w_out": w_out,
    }


def logical_axes(cfg: ArchConfig) -> dict:
    return {
        "w_z": ("embed", "ffn"), "w_xbc": ("embed", "ffn"),
        "w_dt": ("embed", None), "conv_w": ("conv", None),
        "conv_b": (None,), "dt_bias": (None,), "A_log": (None,),
        "D": (None,), "norm_scale": (None,), "w_out": ("ffn", "embed"),
    }


def _local_dims(p, cfg: ArchConfig):
    """(d_in, H, p, n) of the weights ``p``: the whole layer's, or a
    rank's block of the heads."""
    d_in, H = p["w_z"].shape[1], p["A_log"].shape[0]
    return d_in, H, d_in // H, cfg.ssm_state


def _causal_conv(x, w, b, history=None):
    """Depthwise causal conv. x (B,T,C), w (W,C). history (B,W-1,C) or
    None (zeros). The shifted sum of the reference, so no convolution
    library (and no TF32 on the card) touches it."""
    W = w.shape[0]
    if history is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, T+W-1, C)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(W))
    return out + b.to(x.dtype)


def _proj_split(p, x, cfg: ArchConfig):
    dt_ = x.dtype
    z = x @ p["w_z"].to(dt_)                            # (B,T,d_in)
    xbc = x @ p["w_xbc"].to(dt_)                        # (B,T,conv_ch)
    dt_raw = x @ p["w_dt"].to(dt_)                      # (B,T,H)
    return z, xbc, dt_raw


def _post(p, y, z, cfg: ArchConfig, ranks=None):
    """Gated RMSNorm + output projection. y,z (B,T,d_in). With ``ranks``
    y and z are a rank's heads: the norm's mean square is over every
    head (its sum over ``model``), and the output a partial."""
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    if ranks is None:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    else:
        var = ranks.sum_heads(torch.sum(torch.square(yf), dim=-1,
                                        keepdim=True)) \
            / (cfg.ssm_expand * cfg.d_model)
    y = (yf * torch.rsqrt(var + 1e-5) * p["norm_scale"]).to(y.dtype)
    return y @ p["w_out"].to(y.dtype)


def _ssm_inputs(p, x, cfg: ArchConfig):
    """The projections, causal conv and decays shared by every form:
    (z, xs (B,T,H,p), Bm, Cm (B,T,n), dt_v (B,T,H) f32, A (H,))."""
    B, T, d = x.shape
    d_in, H, ph, n = _local_dims(p, cfg)
    z, xbc, dt_raw = _proj_split(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(B, T, H, ph)
    Bm = xbc[..., d_in:d_in + n]
    Cm = xbc[..., d_in + n:]
    dt_v = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                          # (H,) negative
    return z, xs, Bm, Cm, dt_v, A


def apply_mamba2(p, x, cfg: ArchConfig, chunk: int = None, ranks=None):
    """Training/prefill forward, chunked in plain torch. x (B,T,d) ->
    (B,T,d). The (Q, Q) and (Q, H, p) tiles are held in
    ``cfg.ssm_tile_dtype`` and every contraction accumulates in f32, as
    the reference's ``preferred_element_type``. ``ranks``: ``p`` is a
    rank's block of the heads (``rank_weights``; ``_post``)."""
    full_f32()
    B, T, d = x.shape
    d_in, H, ph, n = _local_dims(p, cfg)
    dtype = x.dtype
    tile_dt = getattr(torch, cfg.ssm_tile_dtype)
    chunk = min(chunk or cfg.ssm_chunk, T)
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    nc = T // chunk
    z, xs, Bm, Cm, dt_v, A = _ssm_inputs(p, x, cfg)
    la = dt_v * A[None, None, :]                        # log decay, (B,T,H)

    def f32(a):     # a tile-dtype operand, contracted in f32
        return a.to(tile_dt).to(torch.float32)

    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    h = torch.zeros((B, H, ph, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xs_k, B_k, C_k = xs[:, sl], Bm[:, sl], Cm[:, sl]
        dt_k, la_k = dt_v[:, sl], la[:, sl]
        W = torch.cumsum(la_k, dim=1)                   # (B,Q,H), f32
        W_last = W[:, -1]                               # (B,H)
        C_t, B_t, x_t = f32(C_k), f32(B_k), f32(xs_k)
        # inter-chunk: y_t += C_t (exp(W_t) h_prev)
        decay_to_t = torch.exp(W).to(tile_dt)           # (B,Q,H)
        ch = torch.einsum("bqn,bhpn->bqhp", C_t, f32(h))
        y_inter = ch * decay_to_t[..., None]            # (B,Q,H,p) f32
        # intra-chunk: dt_s exp(W_t - W_s) (C_t . B_s) x_s for s <= t
        G = torch.einsum("bqn,bsn->bqs", C_t, B_t)      # (B,Q,S)
        Wdiff = W[:, :, None, :] - W[:, None, :, :]     # (B,Q,S,H)
        # masked before the exp: above the diagonal Wdiff is a sum of
        # -la > 0 and overflows at strong decays (full width), and a
        # where() after the exp would send 0 * inf = NaN into backward
        Ldec = torch.exp(Wdiff.masked_fill(~tril[None, :, :, None],
                                           float("-inf"))).to(tile_dt)
        att = (G[..., None].to(tile_dt) * Ldec
               * dt_k[:, None].to(tile_dt))             # (B,Q,S,H)
        y_intra = torch.einsum("bqsh,bshp->bqhp", att.to(torch.float32),
                               x_t)
        # state update: h' = exp(W_last) h + sum_s exp(W_last - W_s) dt_s x_s B_s^T
        carry_decay = torch.exp(W_last)                 # (B,H)
        src = (torch.exp(W_last[:, None, :] - W) * dt_k).to(tile_dt)
        xsrc = xs_k.to(tile_dt) * src[..., None]        # (B,Q,H,p)
        h = (carry_decay[:, :, None, None] * h
             + torch.einsum("bqhp,bqn->bhpn", xsrc.to(torch.float32), B_t))
        ys.append((y_inter + y_intra).to(tile_dt))      # (B,Q,H,p)
    y = torch.cat(ys, dim=1)
    y = y + p["D"].to(tile_dt)[None, None, :, None] * xs.to(tile_dt)
    y = y.reshape(B, T, d_in).to(dtype)
    return _post(p, y, z, cfg, ranks)


def apply_mamba2_kernel(p, x, cfg: ArchConfig, ranks=None):
    """Inference/prefill forward through the SSD kernel: the chunk tiles
    stay in shared memory, device memory sees the SSD inputs and outputs
    once. Forward-only (training uses ``apply_mamba2``). ``ranks`` as in
    ``apply_mamba2``: one ``ssd_scan`` on the rank's heads."""
    B, T, d = x.shape
    d_in = _local_dims(p, cfg)[0]
    z, xs, Bm, Cm, dt_v, A = _ssm_inputs(p, x, cfg)
    la = dt_v * A[None, None, :]
    y, _ = ssd_core(xs, Bm, Cm, dt_v, la)
    y = y + p["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(B, T, d_in).to(x.dtype)
    return _post(p, y, z, cfg, ranks)


def rank_heads(cfg: ArchConfig, s, ranks):
    """(first head, heads) of this rank: its block of ``w_z``'s columns
    over ``model`` as whole heads, or every head when they are not
    split."""
    d_in, H, ph = _dims(cfg)[:3]
    if not ranks.on_model(s["w_z"], 1):
        return 0, H
    if H % ranks.M:
        raise NotImplementedError(f"{H} heads of {ph} do not divide a model "
                                  f"axis of {ranks.M}: w_z's block is not "
                                  f"whole heads")
    Hl = H // ranks.M
    return ranks.m * Hl, Hl


def _rank_channels(t, cfg: ArchConfig, h0: int, Hl: int):
    """The conv channels (last dim of ``t``) of heads [h0, h0 + Hl): their
    xs columns, then B and C."""
    d_in, _, ph, n, _ = _dims(cfg)
    if Hl == _dims(cfg)[1]:
        return t
    return torch.cat([t.narrow(-1, h0 * ph, Hl * ph),
                      t.narrow(-1, d_in, 2 * n)], dim=-1)


def rank_weights(p, s, cfg: ArchConfig, ranks):
    """(this rank's weights, ``w_xbc`` whole), FSDP-gathered: ``w_z``,
    ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``norm_scale`` and
    ``w_out`` on its heads (``rank_heads``), and ``w_xbc``, ``conv_w``,
    ``conv_b`` on its conv channels: its heads' xs, then B and C.
    ``w_xbc`` is gathered over ``model`` too when its columns are split
    there."""
    ph = _dims(cfg)[2]
    h0, Hl = rank_heads(cfg, s, ranks)
    w = {name: ranks.gather(p[name], s[name]) for name in p}
    if ranks.on_model(s["w_xbc"], 1):
        w["w_xbc"] = partition.all_gather(w["w_xbc"], "model", ranks.mesh,
                                          axis=1, tiled=True)
    xbc_all = w["w_xbc"]
    if Hl == _dims(cfg)[1]:
        return w, xbc_all
    for name in ("w_xbc", "conv_w", "conv_b"):
        w[name] = _rank_channels(w[name], cfg, h0, Hl)
    for name in ("w_dt", "dt_bias", "A_log", "D"):
        w[name] = w[name].narrow(-1, h0, Hl)
    w["norm_scale"] = w["norm_scale"].narrow(0, h0 * ph, Hl * ph)
    return w, xbc_all


def _rank_kind(s, ranks) -> str:
    return "partial" if ranks.on_model(s["w_out"], 0) else "full"


def apply_mamba2_rank(p, s, x, cfg: ArchConfig, ranks, plain: bool):
    """One rank's layer of the whole-sequence ``x`` (B,T,d), its weights
    this rank's blocks of the specs ``s``: (y, kind) for
    ``Ranks.reduce``. The rank's heads through ``apply_mamba2`` (``plain``)
    or ``apply_mamba2_kernel`` (one ``ssd_scan`` on the card)."""
    w = rank_weights(p, s, cfg, ranks)[0]
    forward = apply_mamba2 if plain else apply_mamba2_kernel
    kind = _rank_kind(s, ranks)
    return forward(w, x, cfg, ranks=ranks if kind == "partial" else None), \
        kind


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> MambaCache:
    d_in, H, p, n, conv_ch = _dims(cfg)
    return MambaCache(
        h=torch.zeros((batch, H, p, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                         device=device))


def decode_step(p, x, cache: MambaCache, cfg: ArchConfig, ranks=None):
    """x (B,1,d) -> (y (B,1,d), new cache). Exact recurrence: the conv
    is an einsum over the (W, C) history in x's dtype, the state update
    runs in f32. Returns new tensors; the cache passed in is left as it
    was. ``ranks`` as in ``apply_mamba2``."""
    full_f32()
    B = x.shape[0]
    d_in, H, ph, n = _local_dims(p, cfg)
    dtype = x.dtype

    z, xbc, dt_raw = _proj_split(p, x, cfg)
    conv_hist = torch.cat([cache.conv, xbc.to(cache.conv.dtype)],
                          dim=1)                        # (B,W,C)
    xbc_t = torch.einsum("bwc,wc->bc", conv_hist.to(dtype),
                         p["conv_w"].to(dtype)) + p["conv_b"].to(dtype)
    xbc_t = F.silu(xbc_t)                               # (B,C)
    new_conv = conv_hist[:, 1:]

    xs = xbc_t[:, :d_in].reshape(B, H, ph)
    Bm = xbc_t[:, d_in:d_in + n]                        # (B,n)
    Cm = xbc_t[:, d_in + n:]                            # (B,n)
    dt_v = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_v * A[None, :])                # (B,H)

    h = (decay[:, :, None, None] * cache.h
         + torch.einsum("bh,bhp,bn->bhpn", dt_v, xs.to(torch.float32),
                        Bm.to(torch.float32)))
    y = torch.einsum("bhpn,bn->bhp", h, Cm.to(torch.float32))
    y = y + p["D"][None, :, None] * xs.to(torch.float32)
    y = y.reshape(B, 1, d_in).to(dtype)
    out = _post(p, y, z, cfg, ranks)
    return out, MambaCache(h=h, conv=new_conv)


def decode_step_rank(p, s, x, cache: MambaCache, cfg: ArchConfig, ranks):
    """One rank's decode step: x (B,1,d) the same on every ``model``
    rank, ``cache.h`` the state of its heads, ``cache.conv`` the history
    of every conv channel. Returns (y, kind, cache): the history takes
    the new input of every channel (``w_xbc`` whole), the state and the
    output come from the rank's channels."""
    w, xbc_all = rank_weights(p, s, cfg, ranks)
    kind = _rank_kind(s, ranks)
    mine = _rank_channels(cache.conv, cfg, *rank_heads(cfg, s, ranks))
    y, new = decode_step(w, x, MambaCache(cache.h, mine), cfg,
                         ranks if kind == "partial" else None)
    xbc = (x @ xbc_all.to(x.dtype)).to(cache.conv.dtype)
    return y, kind, MambaCache(new.h, torch.cat([cache.conv[:, 1:], xbc],
                                                dim=1))


def apply_mamba2_ref(p, x, cfg: ArchConfig):
    """Token-by-token recurrence; numerically exact, O(T) sequential."""
    full_f32()
    B, T, d = x.shape
    d_in, H, ph, n = _local_dims(p, cfg)
    z, xs, Bm, Cm, dt_v, A = _ssm_inputs(p, x, cfg)
    h = torch.zeros((B, H, ph, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt_v[:, t] * A[None, :])      # (B,H)
        h = (decay[:, :, None, None] * h
             + torch.einsum("bh,bhp,bn->bhpn", dt_v[:, t],
                            xs[:, t].to(torch.float32),
                            Bm[:, t].to(torch.float32)))
        ys.append(torch.einsum("bhpn,bn->bhp", h,
                               Cm[:, t].to(torch.float32)))
    y = torch.stack(ys, dim=1)                          # (B,T,H,p)
    y = y + p["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(B, T, d_in).to(x.dtype)
    return _post(p, y, z, cfg)
