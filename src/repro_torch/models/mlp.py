"""MLP variants: SwiGLU / GeGLU / plain GELU (counterpart of
``repro/models/mlp.py``; the RWKV channel mix waits for the rwkv6
family).

``jax.nn.gelu`` defaults to the tanh approximation, and the reference
uses that default, so every GELU here is ``approximate="tanh"``
(PyTorch's own default is the erf form).
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
    raise NotImplementedError(f"mlp_kind {cfg.mlp_kind!r} is not ported yet "
                              f"(ROADMAP.md Queue 1 item 7)")


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg: ArchConfig):
    """x (B,T,d) -> (B,T,d) in x's dtype."""
    dt = x.dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else gelu_tanh
        g = act(x @ p["w_gate"].to(dt))
        u = x @ p["w_up"].to(dt)
        return (g * u) @ p["w_down"].to(dt)
    if cfg.mlp_kind == "gelu":
        h = gelu_tanh(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
        return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
    raise NotImplementedError(f"mlp_kind {cfg.mlp_kind!r} is not ported yet "
                              f"(ROADMAP.md Queue 1 item 7)")
