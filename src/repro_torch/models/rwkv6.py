"""RWKV-6 "Finch" time-mix block — attention-free, data-dependent decay
(counterpart of ``repro/models/rwkv6.py``).

Per head (key/value dims p), with receptance r, key k, value v, per-channel
data-dependent decay w_t and bonus u:

    y_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Three forms of the same function:
  * ``apply_rwkv6``     — the reference's chunked training / prefill form.
                          Everything that does not depend on the carried
                          state (the intra-chunk tiles, the bonus, each
                          chunk's own state term) is computed for all
                          chunks at once; only the carry
                          ``S <- exp(W_last) S + local`` runs chunk by
                          chunk, then ``y_inter`` reads every chunk's
                          incoming state at once.
  * ``decode_step``     — the exact single-token recurrence over an
                          ``RWKVCache``.
  * ``apply_rwkv6_ref`` — the exact token-by-token recurrence (the
                          tests' oracle).

No kernel: the reference computes all three in plain JAX. The channel
mix lives in ``models/mlp.py``.

On a live mesh (``common.Ranks``) a rank runs its block of the heads
(``rank_weights``): ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` are
``("embed", "heads_flat")``, so a rank's columns are whole heads, with
its rows of ``u`` and its columns of ``w0``, ``w_lora_b`` and
``ln_scale``; the group norm and the gate stay on the rank, and ``w_o``
is row-parallel, its output a partial. The forms read the head count
from the weights they are given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._dispatch import full_f32
from repro_torch.models import common


class RWKVCache(NamedTuple):
    S: torch.Tensor          # (B, H, pk, pv) wkv state, f32
    x_att: torch.Tensor      # (B, d) previous normed token (time-mix shift)
    x_ffn: torch.Tensor      # (B, d) previous normed token (channel-mix shift)


def _dims(cfg: ArchConfig):
    return cfg.n_heads, cfg.dim_per_head


def _local_dims(p):
    """(heads, head dim) of the weights ``p``: the whole layer's, or a
    rank's block of the heads."""
    return tuple(p["u"].shape)


def init_rwkv6(cfg: ArchConfig, gen) -> dict:
    d = cfg.d_model
    H, p = _dims(cfg)
    lora = max(32, d // 32)
    dev = gen.device
    half = lambda: 0.5 * torch.ones((d,), device=dev)  # noqa: E731
    return {
        "mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_w": half(),
        "mix_g": half(),
        "w_r": common.he_init(gen, (d, d), d),
        "w_k": common.he_init(gen, (d, d), d),
        "w_v": common.he_init(gen, (d, d), d),
        "w_g": common.he_init(gen, (d, d), d),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": -6.0 + common.normal_init(gen, (d,), 0.5),
        "w_lora_a": common.he_init(gen, (d, lora), d),
        "w_lora_b": common.normal_init(gen, (lora, d), 0.01),
        "u": common.normal_init(gen, (H, p), 0.5),
        "ln_scale": torch.ones((d,), device=dev),
        "w_o": common.he_init(gen, (d, d), d),
    }


def logical_axes(cfg: ArchConfig) -> dict:
    return {
        "mix_r": (None,), "mix_k": (None,), "mix_v": (None,), "mix_w": (None,),
        "mix_g": (None,),
        "w_r": ("embed", "heads_flat"), "w_k": ("embed", "heads_flat"),
        "w_v": ("embed", "heads_flat"), "w_g": ("embed", "heads_flat"),
        "w0": (None,), "w_lora_a": ("embed", None), "w_lora_b": (None, None),
        "u": ("heads", None), "ln_scale": (None,), "w_o": ("heads_flat", "embed"),
    }


def _shift(x, x_prev):
    """Token shift: x_{t-1} with x_prev filling t=0. x (B,T,d), x_prev
    (B,d)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1]], dim=1)


def _mix_heads(p, x, x_prev, cfg: ArchConfig):
    """r, k, v (B,T,H,p) and g (B,T,d) in x's dtype, the log decay
    (B,T,H,p) in f32. The decay LoRA runs in f32 on the f32 weights."""
    B, T, d = x.shape
    H, ph = _local_dims(p)
    dt = x.dtype
    xs = _shift(x, x_prev)

    def mix(m):
        return x + (xs - x) * p[m].to(dt)

    r = (mix("mix_r") @ p["w_r"].to(dt)).reshape(B, T, H, ph)
    k = (mix("mix_k") @ p["w_k"].to(dt)).reshape(B, T, H, ph)
    v = (mix("mix_v") @ p["w_v"].to(dt)).reshape(B, T, H, ph)
    g = F.silu(mix("mix_g") @ p["w_g"].to(dt))
    xw = mix("mix_w").to(torch.float32)
    lw = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    # per-token log decay in [-5, 0): the chunked form's exp(+/-W)
    # factors stay inside f32 range (see apply_rwkv6)
    logw = -torch.exp(torch.clamp(lw, -20.0, 1.609))
    return r, k, v, g, logw.reshape(B, T, H, ph)


def _group_norm(y, scale, cfg: ArchConfig, eps=64e-5):
    """Per-head LayerNorm (RWKV 'ln_x'), population variance, in f32;
    returned in y's dtype. y (B,T,H,p) -> (B,T,H*p)."""
    yf = y.to(torch.float32)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, unbiased=False)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    B, T, H, p = y.shape
    return (yn.reshape(B, T, H * p) * scale).to(y.dtype)


def _out(p, y, g, cfg: ArchConfig, dtype):
    """Group norm of the f32 wkv output y (B,T,H,p), the f32 gate
    product, then the output projection in ``dtype``."""
    y = _group_norm(y, p["ln_scale"], cfg)
    return (y * g).to(dtype) @ p["w_o"].to(dtype)


def apply_rwkv6(p, x, cfg: ArchConfig, x_prev=None, chunk: int = 32):
    """Training/prefill forward. x (B,T,d) -> (B,T,d).

    x_prev (B,d): last token of the previous segment (zeros at sequence
    start). Raises unless T is a multiple of ``min(chunk, T)``.
    """
    full_f32()
    B, T, d = x.shape
    H, ph = _local_dims(p)
    dtype = x.dtype
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    nc = T // chunk
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=dtype, device=x.device)

    r, k, v, g, logw = _mix_heads(p, x, x_prev, cfg)
    shape = (B, nc, chunk, H, ph)
    r_f = r.to(torch.float32).reshape(shape)
    k_f = k.to(torch.float32).reshape(shape)
    v_f = v.to(torch.float32).reshape(shape)
    lw = logw.reshape(shape)
    W = torch.cumsum(lw, dim=2)                  # inclusive, within a chunk
    Wm1 = W - lw                                 # exclusive (up to t-1)
    W_last = W[:, :, -1]                         # (B,nc,H,pk)
    # intra-chunk (s < t): A[t,s] = sum_k (r_t,k e^{Wm1_t-c}) (k_s,k e^{c-W_s})
    # with c = W_last/2, each factor inside f32 range for chunk <= 32.
    # Above the diagonal their product reaches e^{-W_last} (up to e^160 at
    # the decay clamp): inf, or NaN where signs mix. ``where`` clears it
    # and sends an exact 0 cotangent back to finite factors; a product
    # with the mask would give inf * 0 = NaN, forward and backward.
    c = 0.5 * W_last[:, :, None]
    rdec = r_f * torch.exp(Wm1 - c)
    kdec = k_f * torch.exp(c - W)
    att = torch.einsum("bcqhk,bcshk->bchqs", rdec, kdec)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device), diagonal=-1)
    att = torch.where(lower, att, 0.0)
    y_intra = torch.einsum("bchqs,bcshv->bcqhv", att, v_f)
    # current-token bonus: (r_t . (u * k_t)) v_t
    bonus = torch.einsum("bcqhk,hk,bcqhk->bcqh", r_f, p["u"], k_f)
    y_bonus = bonus[..., None] * v_f
    # each chunk's own state term sum_s e^{W_last - W_s} k_s v_s^T
    ksrc = k_f * torch.exp(W_last[:, :, None] - W)
    local = torch.einsum("bcshk,bcshv->bchkv", ksrc, v_f)
    decay = torch.exp(W_last)[..., None]         # (B,nc,H,pk,1)
    # the carry, chunk by chunk: S_new = diag(exp(W_last)) S + local
    S = torch.zeros((B, H, ph, ph), dtype=torch.float32, device=x.device)
    incoming = []
    for ci in range(nc):
        incoming.append(S)
        S = torch.addcmul(local[:, ci], decay[:, ci], S)
    # inter-chunk: y_t += (r_t * exp(Wm1_t))^T S_prev  (Wm1 <= 0, safe)
    y_inter = torch.einsum("bcqhk,bchkv->bcqhv", r_f * torch.exp(Wm1),
                           torch.stack(incoming, dim=1))
    y = (y_inter + y_intra + y_bonus).reshape(B, T, H, ph)
    return _out(p, y, g, cfg, dtype)


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> RWKVCache:
    H, ph = _dims(cfg)
    return RWKVCache(
        S=torch.zeros((batch, H, ph, ph), dtype=torch.float32, device=device),
        x_att=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        x_ffn=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))


def _wkv_step(r_t, k_t, v_t, logw_t, u, S):
    """One token of the recurrence, f32: (y (B,H,pv), new S)."""
    kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
    y = torch.einsum("bhk,bhkv->bhv", r_t, u[None, :, :, None] * kv + S)
    return y, torch.exp(logw_t)[..., None] * S + kv


def decode_step(p, x, cache: RWKVCache, cfg: ArchConfig):
    """Exact single-token recurrence. x (B,1,d) -> (y (B,1,d), new
    cache); the state update in f32. The cache passed in is left as it
    was."""
    full_f32()
    B = x.shape[0]
    H, ph = _local_dims(p)
    r, k, v, g, logw = _mix_heads(p, x, cache.x_att.to(x.dtype), cfg)
    f32 = lambda a: a[:, 0].to(torch.float32)  # noqa: E731
    y, S_new = _wkv_step(f32(r), f32(k), f32(v), logw[:, 0], p["u"],
                         cache.S)
    out = _out(p, y.reshape(B, 1, H, ph), g, cfg, x.dtype)
    return out, RWKVCache(S=S_new, x_att=x[:, 0], x_ffn=cache.x_ffn)


def rank_weights(p, s, cfg: ArchConfig, ranks):
    """This rank's time-mix weights, FSDP-gathered: the columns of
    ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` (its heads), its rows of ``u``
    and ``w_o``, and the same columns of ``w0``, ``w_lora_b`` and
    ``ln_scale``; every head when they are not split over ``model``."""
    w = {name: ranks.gather(p[name], s[name]) for name in p}
    cols = w["w_r"].shape[1]
    if cols != w["u"].numel():
        raise NotImplementedError(f"{cfg.n_heads} heads of "
                                  f"{cfg.dim_per_head} do not divide a "
                                  f"model axis of {ranks.M}: w_r's block "
                                  f"is not whole heads")
    if ranks.on_model(s["w_r"], 1):
        for name in ("w0", "w_lora_b", "ln_scale"):
            w[name] = w[name].narrow(-1, ranks.m * cols, cols)
    return w


def apply_rwkv6_rank(p, s, x, cfg: ArchConfig, ranks):
    """One rank's time mix of the whole-sequence ``x`` (B,T,d) (the
    token shift reads the previous row, so the sequence comes whole):
    (y, kind) for ``Ranks.reduce``, ``"partial"`` when the heads are
    split over ``model``."""
    kind = "partial" if ranks.on_model(s["w_o"], 0) else "full"
    return apply_rwkv6(rank_weights(p, s, cfg, ranks), x, cfg), kind


# ---------------------------------------------------------------------------
# Reference: exact token-by-token recurrence (oracle for the chunked form).
# ---------------------------------------------------------------------------

def apply_rwkv6_ref(p, x, cfg: ArchConfig, x_prev=None):
    full_f32()
    B, T, d = x.shape
    H, ph = _local_dims(p)
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _mix_heads(p, x, x_prev, cfg)
    r_f, k_f, v_f = (a.to(torch.float32) for a in (r, k, v))
    S = torch.zeros((B, H, ph, ph), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        y, S = _wkv_step(r_f[:, t], k_f[:, t], v_f[:, t], logw[:, t],
                         p["u"], S)
        ys.append(y)
    return _out(p, torch.stack(ys, dim=1), g, cfg, x.dtype)
