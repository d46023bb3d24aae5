"""Backbone assembly for the dense and hybrid (zamba2) families: the
full-sequence forward of ``repro/models/transformer.py``.

  dense           -> attention block + MLP, ``n_layers`` times
  hybrid (zamba2) -> groups of ``shared_attn_every`` mamba2 blocks, each
                     group followed by the one *shared* attention + GELU
                     MLP block (sliding window ``shared_attn_window``)

The ssm (rwkv6), moe, vlm and audio families, decode and its caches wait
for later slices (ROADMAP.md Queue 1 item 7): ``Model`` raises
``NotImplementedError`` for them.

Public surface:
    model = Model(cfg, device=None)             # the card unless "cpu"
    h, aux = model.hidden({"tokens": tokens})   # (B,T,d) final-normed
    logits, aux = model.apply({"tokens": tokens})
    emb = model.embed_pool({"tokens": tokens})  # (B, d) f32, for DML

Parameters keep the reference's names: ``model.embedding.tok``,
``model.blocks[i].mamba.w_z``, ``model.shared.attn.wq``, ... — the
reference's stacked ``blocks`` pytree becomes an ``nn.ModuleList`` of
one ``ParamTree`` per layer. They are inference weights
(``requires_grad=False``): the forward runs mamba blocks through
``apply_mamba2_kernel`` and attention through ``attend``, whose kernels
are forward-only. ``plain=True`` runs the reference's own forms instead
(``apply_mamba2``, naive / chunked attention), on any device: the
differentiable path of the training slice, and what the kernel path is
held against on the card. ``Model.apply`` keeps the reference's name and
so shadows ``nn.Module.apply``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import full_f32
from repro_torch.models import attention, common, mamba2, mlp

FAMILIES = ("dense", "hybrid")


class ParamTree(nn.Module):
    """A nested dict of tensors as modules and (frozen) parameters, read
    with the reference's keys: ``tree["attn"]["wq"]``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)


# ---------------------------------------------------------------------------
# Per-layer blocks
# ---------------------------------------------------------------------------

def _init_attn_block(cfg: ArchConfig, gen) -> dict:
    dev = gen.device
    p = {"norm1": common.init_norm(cfg, cfg.d_model, dev),
         "attn": attention.init_attention(cfg, gen)}
    if not cfg.parallel_block:
        p["norm2"] = common.init_norm(cfg, cfg.d_model, dev)
    p["mlp"] = mlp.init_mlp(cfg, gen)
    return p


def _init_mamba_block(cfg: ArchConfig, gen) -> dict:
    return {"norm1": common.init_norm(cfg, cfg.d_model, gen.device),
            "mamba": mamba2.init_mamba2(cfg, gen)}


def _apply_attn_block(p, x, cfg: ArchConfig, positions, plain: bool):
    h = common.apply_norm(p["norm1"], x, cfg)
    q, k, v = attention.qkv_proj(p["attn"], h, positions, cfg)
    attend = attention.attend_plain if plain else attention.attend
    att_out = attention.out_proj(p["attn"], attend(q, k, v, cfg), cfg)
    if cfg.parallel_block:
        return x + att_out + mlp.apply_mlp(p["mlp"], h, cfg)
    x = x + att_out
    h2 = common.apply_norm(p["norm2"], x, cfg)
    return x + mlp.apply_mlp(p["mlp"], h2, cfg)


def _apply_mamba_block(p, x, cfg: ArchConfig, plain: bool):
    h = common.apply_norm(p["norm1"], x, cfg)
    forward = mamba2.apply_mamba2 if plain else mamba2.apply_mamba2_kernel
    return x + forward(p["mamba"], h, cfg)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """The reference's parameter tree on ``gen``'s device, with
    ``blocks`` as a list of per-layer dicts (dense or hybrid ``cfg``)."""
    block_init = (_init_mamba_block if cfg.family == "hybrid"
                  else _init_attn_block)
    params = {"embedding": common.init_embedding(cfg, gen),
              "blocks": [block_init(cfg, gen) for _ in range(cfg.n_layers)],
              "final_norm": common.init_norm(cfg, cfg.d_model, gen.device)}
    if cfg.shared_attn_every:
        params["shared"] = _init_attn_block(shared_cfg(cfg), gen)
    return params


def shared_cfg(cfg: ArchConfig) -> ArchConfig:
    """Config view for zamba2's shared attention block (windowed full
    attention + gelu MLP at d_model)."""
    return cfg.replace(block_kind="attn", n_experts=0, attention="sliding",
                       window=cfg.shared_attn_window, mlp_kind="gelu",
                       family="dense")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """A dense or hybrid backbone. ``device=None`` is the card (raises
    without one); ``device="cpu"`` runs the plain versions of the
    kernels. ``params`` (the reference's tree, ``blocks`` a list of
    per-layer dicts, as ``convert.model_params_from_jax`` gives it)
    replaces the seeded init."""

    def __init__(self, cfg: ArchConfig, device=None, params=None,
                 seed: int = 0):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
                f"port builds {FAMILIES} (ROADMAP.md Queue 1 item 7)")
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(cfg, gen)
        self.embedding = ParamTree(params["embedding"])
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])
        self.final_norm = ParamTree(params["final_norm"])
        if cfg.shared_attn_every:
            self.shared = ParamTree(params["shared"])
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embedding.tok.device

    # ----- full-sequence forward (prefill / embedding) -----

    def apply(self, batch: Dict[str, Any], plain: bool = False):
        """Returns (logits (B,T,V), aux dict)."""
        h, aux = self.hidden(batch, plain=plain)
        return common.unembed(self.embedding, h, self.cfg), aux

    def hidden(self, batch: Dict[str, Any], plain: bool = False):
        """Final normed hidden states (B,T,d) + aux."""
        h = self._backbone(batch, plain)
        return h, {"moe_aux": torch.zeros((), device=h.device)}

    def embed_pool(self, batch: Dict[str, Any], plain: bool = False):
        """Mean-pooled final hidden state (B, d_model) f32 — the embedding
        the DML metric head consumes."""
        h = self._backbone(batch, plain)
        return torch.mean(h.to(torch.float32), dim=1)

    def _backbone(self, batch, plain: bool):
        full_f32()          # f32 configs: true f32 products, as the reference
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        tokens = batch["tokens"].to(self.device)
        x = common.embed_tokens(self.embedding, tokens, cfg, dtype)
        B, T, _ = x.shape
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        x = self._run_blocks(x, positions, plain)
        return common.apply_norm(self.final_norm, x, cfg)

    def _run_blocks(self, x, positions, plain: bool):
        if self.cfg.family == "hybrid":
            return self._run_hybrid(x, positions, plain)
        for p_l in self.blocks:
            x = _apply_attn_block(p_l, x, self.cfg, positions, plain)
        return x

    def _run_hybrid(self, x, positions, plain: bool):
        """Zamba2: groups of mamba layers + the shared attention block."""
        cfg = self.cfg
        every = cfg.shared_attn_every
        if cfg.n_layers % every:
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple "
                             f"of shared_attn_every={every}")
        scfg = shared_cfg(cfg)
        for g in range(cfg.n_layers // every):
            for p_l in self.blocks[g * every:(g + 1) * every]:
                x = _apply_mamba_block(p_l, x, cfg, plain)
            x = _apply_attn_block(self.shared, x, scfg, positions, plain)
        return x

