"""MLP variants: SwiGLU / GeGLU / plain GELU, and the RWKV channel mix
(counterpart of ``repro/models/mlp.py``).

``jax.nn.gelu`` defaults to the tanh approximation, and the reference
uses that default, so every GELU here is ``approximate="tanh"``
(PyTorch's own default is the erf form).

``apply_mlp_rank`` is one rank's MLP on a live mesh (``common.Ranks``):
column-parallel then row-parallel over ``"ffn"`` on ``model`` (the
reference's ``constrain`` of the hidden layer), its weights all-gathered
over ``data`` (FSDP). The RWKV channel mix's receptance ``w_r`` is
``("embed", "embed2")``, whole on every rank: it gates the reduced
output on the rank's own rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common


def init_mlp(cfg: ArchConfig, gen) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"w_gate": common.he_init(gen, (d, f), d),
                "w_up": common.he_init(gen, (d, f), d),
                "w_down": common.he_init(gen, (f, d), f)}
    if cfg.mlp_kind == "gelu":
        zeros = lambda n: torch.zeros((n,), device=gen.device)  # noqa: E731
        return {"w_up": common.he_init(gen, (d, f), d), "b_up": zeros(f),
                "w_down": common.he_init(gen, (f, d), f), "b_down": zeros(d)}
    if cfg.mlp_kind == "rwkv_channel_mix":
        half = lambda: 0.5 * torch.ones((d,), device=gen.device)  # noqa: E731
        return {"mix_k": half(), "w_k": common.he_init(gen, (d, f), d),
                "w_v": common.he_init(gen, (f, d), f), "mix_r": half(),
                "w_r": common.he_init(gen, (d, d), d)}
    raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")


def logical_axes(cfg: ArchConfig) -> dict:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
                "w_down": ("ffn", "embed")}
    if cfg.mlp_kind == "gelu":
        return {"w_up": ("embed", "ffn"), "b_up": ("ffn",),
                "w_down": ("ffn", "embed"), "b_down": ("embed",)}
    return {"mix_k": (None,), "w_k": ("embed", "ffn"), "w_v": ("ffn", "embed"),
            "mix_r": (None,), "w_r": ("embed", "embed2")}


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg: ArchConfig, x_prev=None):
    """x (B,T,d) -> (B,T,d) in x's dtype. ``x_prev`` is the token-shifted
    input, which the RWKV channel mix needs."""
    dt = x.dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else gelu_tanh
        g = act(x @ p["w_gate"].to(dt))
        u = x @ p["w_up"].to(dt)
        return (g * u) @ p["w_down"].to(dt)
    if cfg.mlp_kind == "gelu":
        h = gelu_tanh(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
        return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
    if cfg.mlp_kind == "rwkv_channel_mix":
        if x_prev is None:
            raise ValueError("the rwkv channel mix needs x_prev (token shift)")
        xk = x + (x_prev - x) * p["mix_k"].to(dt)
        xr = x + (x_prev - x) * p["mix_r"].to(dt)
        k = torch.square(torch.relu(xk @ p["w_k"].to(dt)))
        r = torch.sigmoid(xr @ p["w_r"].to(dt))
        return r * (k @ p["w_v"].to(dt))
    raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")


def apply_mlp_rank(p, s, x, cfg: ArchConfig, ranks, x_prev=None,
                   sp: bool = False):
    """One rank's MLP of the whole-sequence ``x`` (B,T,d), its weights
    this rank's blocks of the specs ``s``: (y, kind) for
    ``Ranks.reduce``, ``"partial"`` when the hidden layer is split over
    ``model`` (its down projection's sum is over the ranks). The RWKV
    channel mix (``x_prev`` the whole sequence shifted) reduces its
    value itself into the residual's layout (its rows when ``sp``) and
    gates it there: kind ``"sp"``."""
    dt = x.dtype
    w = {n: ranks.gather(p[n], s[n]) for n in p}
    if cfg.mlp_kind == "rwkv_channel_mix":
        if x_prev is None:
            raise ValueError("the rwkv channel mix needs x_prev (token shift)")
        kind = "partial" if ranks.on_model(s["w_v"], 0) else "full"
        xk = x + (x_prev - x) * w["mix_k"].to(dt)
        k = torch.square(torch.relu(xk @ w["w_k"].to(dt)))
        kv = ranks.reduce(k @ w["w_v"].to(dt), kind, sp)
        x, x_prev = (ranks.reduce(t, "full", sp) for t in (x, x_prev))
        xr = x + (x_prev - x) * w["mix_r"].to(dt)
        return torch.sigmoid(xr @ w["w_r"].to(dt)) * kv, "sp"
    kind = "partial" if ranks.on_model(s["w_down"], 0) else "full"
    if cfg.mlp_kind == "gelu":
        h = gelu_tanh(x @ w["w_up"].to(dt) + w["b_up"].to(dt))
        return ranks.bias(h @ w["w_down"].to(dt), w["b_down"], kind), kind
    act = F.silu if cfg.mlp_kind == "swiglu" else gelu_tanh
    h = act(x @ w["w_gate"].to(dt)) * (x @ w["w_up"].to(dt))
    return h @ w["w_down"].to(dt), kind
