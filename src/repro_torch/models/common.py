"""Shared model building blocks: norms, RoPE, initializers, embeddings
(counterpart of ``repro/models/common.py``).

Parameters are nested dicts of tensors (``init_*`` builds them from a
``torch.Generator`` on the generator's device, or shapes without values
from ``META``); the ``apply``-style functions take any mapping with the
reference's keys, such as the model's ``ParamTree`` modules.

``Ranks`` is a model's per-rank program on a live mesh (the
sharding plan's blocks, ``sharding/partition.py``): FSDP gathers over
the batch axes, the sequence-parallel residual over ``model``, the
vocab-parallel embedding (``embed_tokens_rank``) or the frame / patch
projection (``embed_frontend_rank``), and the logits (``unembed_rank``)
at the reference's ``constrain`` points.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import partition


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


# --------------------------------------------------------------------------
# The per-rank program on a live mesh
# --------------------------------------------------------------------------

def _axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


class Ranks:
    """One rank of a model's program on a live ``mesh``: weights
    arrive as this rank's blocks of the plan's specs; ``gather`` is the
    FSDP all-gather of a weight over every axis but ``model`` that its
    spec shards it on; the residual between blocks is sequence-parallel
    over ``model`` (``"seq_sp"``) when the sequence divides it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.M = mesh.shape.get("model", 1)
        self.model = "model" if self.M > 1 else None
        self.m = mesh.axis_index("model") if self.model else 0
        self.batch = tuple(a for a in ("pod", "data") if a in mesh.shape)

    def gather(self, w, spec):
        """``w`` gathered over the non-``model`` axes of ``spec``: the
        weight this rank computes with (its ``model`` block, if any)."""
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            fsdp = tuple(a for a in axes if a != "model")
            if fsdp and len(fsdp) < len(axes):
                raise NotImplementedError(f"spec {spec} mixes model with "
                                          f"another axis on one dimension")
            if fsdp:
                w = partition.all_gather(w, fsdp, self.mesh, axis=dim,
                                         tiled=True)
        return w

    @staticmethod
    def on_model(spec, dim: int) -> bool:
        return "model" in _axes(spec[dim]) if dim < len(spec) else False

    def sp(self, T: int) -> bool:
        """Whether a sequence of ``T`` is split over ``model`` between
        blocks."""
        return self.model is not None and T % self.M == 0

    def seq_gather(self, x, sp: bool):
        """The whole sequence of the residual ``x`` (B, T/M, d)."""
        if not sp:
            return x
        return partition.all_gather(x, "model", self.mesh, axis=1,
                                    tiled=True)

    def psum_model(self, x):
        return partition.psum(x, "model", self.mesh) if self.model else x

    def sum_heads(self, x):
        """The sum over ``model`` of a value each rank computes on its
        own heads and reads again on them (a norm over every head): one
        all-reduce, and ``partition.pvary`` so that its backward sums the
        ranks' cotangents."""
        if not self.model:
            return x
        return partition.pvary(self.psum_model(x), "model", self.mesh)

    def reduce(self, y, kind: str, sp: bool):
        """A sublayer's output as the residual: ``"partial"`` (sums over
        ``model``) reduce-scattered into the sequence-parallel residual
        (all-reduced when the sequence is not split), ``"full"`` (the
        whole sequence on every rank) cut to this rank's rows, ``"sp"``
        as it is."""
        if kind == "partial":
            if sp:
                return partition.psum_scatter(y, "model", self.mesh,
                                              scatter_dimension=1,
                                              tiled=True)
            return self.psum_model(y)
        if kind == "full" and sp:
            step = y.shape[1] // self.M
            return y.narrow(1, self.m * step, step)
        return y

    def bias(self, y, b, kind: str):
        """``y`` plus the bias ``b``, once over ``model`` where ``y`` is a
        partial (on its rank 0)."""
        if kind == "partial" and self.m:
            return y
        return y + b.to(y.dtype)


def _vocab_slot(tokens, tok, spec, ranks):
    """(this rank's row of each token in its vocab block, whether the
    block holds it); every token when the vocab is not sharded."""
    if not ranks.on_model(spec, 0):
        return tokens.long(), None
    V_l = tok.shape[0]
    local = tokens.long() - ranks.m * V_l
    inside = (local >= 0) & (local < V_l)
    return local.clamp(0, V_l - 1), inside


def embed_tokens_rank(p, s, tokens, cfg: ArchConfig, dtype, ranks: Ranks,
                      sp: bool):
    """The vocab-parallel lookup of this rank's ``tokens`` (B, T): the
    ids outside its vocab block masked, the rows summed over ``model``
    (reduce-scattered into the sequence-parallel residual (B, T/M, d)
    when ``sp``); a replicated vocab is looked up whole."""
    tok = ranks.gather(p["tok"], s["tok"])
    idx, inside = _vocab_slot(tokens, tok, s["tok"], ranks)
    x = tok[idx].to(dtype)
    if inside is not None:
        x = torch.where(inside[..., None], x, torch.zeros_like(x))
        x = ranks.reduce(x, "partial", sp)
    else:
        x = ranks.reduce(x, "full", sp)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    return x


def embed_frontend_rank(p, s, embeddings, cfg: ArchConfig, dtype,
                        ranks: Ranks, sp: bool):
    """``embed_frontend`` on one rank: its batch's frame / patch
    embeddings (B, T, d) cut first to its sequence-parallel rows when
    ``sp`` (the product is row by row), then through ``frontend_proj``
    gathered over ``data`` (``("embed", "embed2")``, ``"embed2"``
    replicated): the residual as ``Ranks.reduce`` leaves it."""
    x = ranks.reduce(embeddings, "full", sp)
    w = ranks.gather(p["frontend_proj"], s["frontend_proj"])
    return x.to(dtype) @ w.to(dtype)


def unembed_weight(p, s, cfg: ArchConfig, ranks: Ranks):
    """The (d, V / M) unembedding of this rank's vocab block (the whole
    vocab when it does not divide ``model``), FSDP-gathered."""
    if cfg.tie_embeddings:
        return ranks.gather(p["tok"], s["tok"]).T
    return ranks.gather(p["unembed"], s["unembed"])


def unembed_rank(p, s, x, cfg: ArchConfig, ranks: Ranks):
    """Logits of the whole-sequence ``x`` over this rank's vocab block
    (``("batch", "seq", "vocab")``, the reference's ``transformer.py``
    constrain): (..., V / M) when the vocab divides ``model``."""
    return x @ unembed_weight(p, s, cfg, ranks).to(x.dtype)


def vocab_block(cfg: ArchConfig, s, ranks: Ranks):
    """(first id, ids) of this rank's vocab block of the logits."""
    spec = s["tok"] if cfg.tie_embeddings else s["unembed"]
    dim = 0 if cfg.tie_embeddings else 1
    if not ranks.on_model(spec, dim):
        return 0, cfg.vocab_size
    V_l = cfg.vocab_size // ranks.M
    return ranks.m * V_l, V_l
