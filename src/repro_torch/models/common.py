"""Shared model building blocks: norms, RoPE, initializers, embeddings
(counterpart of ``repro/models/common.py``).

Parameters are nested dicts of tensors (``init_*`` builds them from a
``torch.Generator`` on the generator's device, or shapes without values
from ``META``); the ``apply``-style functions take any mapping with the
reference's keys, such as the model's ``ParamTree`` modules.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where parameters are built on
    ``meta`` (shapes and dtypes, no storage, no values): ``torch`` has no
    generator on that device."""

    device = torch.device("meta")


META = MetaGenerator()


def randn(gen, shape) -> torch.Tensor:
    """Standard normal draws from ``gen`` on its device."""
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def rand(gen, shape) -> torch.Tensor:
    """Uniform [0, 1) draws from ``gen`` on its device."""
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device)


def normal_init(gen, shape, stddev):
    return stddev * randn(gen, shape)


def he_init(gen, shape, fan_in):
    return randn(gen, shape) / float(np.sqrt(fan_in))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, d: int, device):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, cfg: ArchConfig):
    """RMSNorm or LayerNorm in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm_kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] \
            + p["bias"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T) int. Rotates the two halves
    of the head dim (``jnp.split``), not interleaved pairs."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., T, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def init_embedding(cfg: ArchConfig, gen) -> dict:
    p = {"tok": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), 0.02)
    if cfg.input_kind == "embeddings":
        # projector from the (stubbed) modality frontend's embedding space
        p["frontend_proj"] = he_init(gen, (cfg.d_model, cfg.d_model),
                                     cfg.d_model)
    return p


def logical_axes_embedding(cfg: ArchConfig) -> dict:
    lg = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        lg["unembed"] = ("embed", "vocab")
    if cfg.input_kind == "embeddings":
        lg["frontend_proj"] = ("embed", "embed2")
    return lg


def embed_tokens(p, tokens, cfg: ArchConfig, dtype):
    x = p["tok"][tokens].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    return x


def embed_frontend(p, embeddings, cfg: ArchConfig, dtype):
    """Modality carve-out: precomputed frame / patch embeddings (B, T,
    d_model) -> d_model, in ``dtype``."""
    return embeddings.to(dtype) @ p["frontend_proj"].to(dtype)


def unembed(p, x, cfg: ArchConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w.to(x.dtype)
