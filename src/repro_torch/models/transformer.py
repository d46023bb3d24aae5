"""Backbone assembly for every family of the configs (counterpart of
``repro/models/transformer.py``).

  dense, vlm, audio -> attention block + MLP, ``n_layers`` times
  moe               -> attention block + MoE FFN (``models/moe.py``;
                       expert-parallel over a live ``mesh``), ``n_layers``
                       times; each layer's router aux loss is summed
                       into ``moe_aux``
  ssm (rwkv6)       -> rwkv6 time mix + RWKV channel mix, ``n_layers``
                       times
  hybrid (zamba2)   -> groups of ``shared_attn_every`` mamba2 blocks, each
                       group followed by the one *shared* attention +
                       GELU MLP block (sliding window
                       ``shared_attn_window``)

The vlm (pixtral-12b) and audio (hubert-xlarge: ``causal=False``,
encoder-only, no decode) configs have ``input_kind="embeddings"``: a
batch with ``"embeddings"`` (B, T, d_model), the stubbed frontend's
frame / patch embeddings, enters through ``common.embed_frontend``
(``frontend_proj``); a batch of ``"tokens"`` through the token
embedding, as for the other families (the reference's
``_embed_inputs``), so pixtral also decodes on tokens.

Public surface:
    model = Model(cfg, device=None)             # the card unless "cpu"
    h, aux = model.hidden({"tokens": tokens})   # (B,T,d) final-normed
    h, aux = model.hidden({"embeddings": e})    # vlm / audio; e (B,T,d)
    logits, aux = model.apply({"tokens": tokens})
    emb = model.embed_pool({"tokens": tokens})  # (B, d) f32, for DML
    cache = model.init_decode_cache(batch, max_seq)
    logits, cache = model.decode_step(cache, tokens, pos)   # (B, V)

``apply`` / ``hidden`` / ``embed_pool`` / ``decode_step`` take the
reference's ``mesh=``. On a live mesh (``launch/mesh.LiveMesh``) every
family runs its per-rank program (``rank_map`` / ``rank_decode_map``,
one ``partition.shard_map`` over the sharding plan's specs): FSDP
gathers over ``data``, heads and ffn over ``model`` (column- then
row-parallel, the partials reduce-scattered into the sequence-parallel
residual ``seq_sp`` between blocks), the vocab-parallel embedding (or
the frame / patch ``frontend_proj`` on the rank's rows) and logits,
context parallelism where the heads do not divide ``model`` and a
decode cache over ``cache_seq`` where the kv heads do not; each moe
layer is the expert-parallel map nested in the program
(``moe.apply_moe_rank``: the rank's experts over its batch shard, the
partial reduce-scattered like the MLP's, ``moe_aux`` the sum of the
layers' pmeaned aux); global values in, global values out. The
recurrent families run their mixers on the rank's heads over the whole
sequence (the token shift, the chunk carry, the conv and the SSD read
every earlier row): rwkv6's time mix (``rwkv6.apply_rwkv6_rank``) and
channel mix (``mlp.apply_mlp_rank``), zamba2's mamba2 heads
(``mamba2.apply_mamba2_rank``, one ``ssd_scan`` a layer on the card)
and its shared block as an attention block on the rank's heads. Their
decode map takes the cache in the reference's stacked layout under its
plan (``stacked_cache_specs``), whose layout is not always the one a
rank computes with (rwkv6's wkv state over its key dim, zamba2's conv
history over its batch): the program moves each leaf to its working
layout and back (``partition.reblock``).

Parameters keep the reference's names: ``model.embedding.tok``,
``model.blocks[i].mamba.w_z``, ``model.shared.attn.wq``, ... — the
reference's stacked ``blocks`` pytree becomes an ``nn.ModuleList`` of
one ``ParamTree`` per layer, and its stacked decode caches per-layer
lists (``stack_blocks`` / ``unstack_blocks`` convert a tree between the
two layouts). The module's parameters are inference weights
(``requires_grad=False``): the forward runs mamba blocks through
``apply_mamba2_kernel`` and attention through ``attend``, whose kernels
are forward-only. ``plain=True`` runs the reference's own forms instead
(``apply_mamba2``, naive / chunked attention), on any device: the
training forms, and what the kernel path is held against on the card.
The ssm family has no kernel (the reference computes rwkv6 in plain
JAX), so both settings run its chunked ``apply_rwkv6``.
Training differentiates ``hidden(batch, plain=True, params=tree)``,
where ``tree`` is the reference-shaped parameter tree
(``param_tree()``) of tensors that the optimizer steps, as the
reference's ``Model.hidden(params, batch)`` takes them. Decode is plain
torch on every device: the reference computes it without a kernel.
``Model.apply`` keeps the reference's name and so shadows
``nn.Module.apply``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import full_f32
from repro_torch.launch.mesh import LiveMesh
from repro_torch.models import attention, common, mamba2, mlp, moe, rwkv6
from repro_torch.sharding import partition
from repro_torch.tree import tree_leaves, tree_map

FAMILIES = ("dense", "hybrid", "ssm", "moe", "vlm", "audio")


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
    if _is_moe(cfg):
        p["moe"] = moe.init_moe(cfg, gen)
    else:
        p["mlp"] = mlp.init_mlp(cfg, gen)
    return p


def _is_moe(cfg: ArchConfig) -> bool:
    """Whether an attention block's FFN is the MoE (the reference's
    ``"moe" in p``)."""
    return bool(cfg.n_experts) and cfg.family == "moe"


def _init_rwkv_block(cfg: ArchConfig, gen) -> dict:
    dev = gen.device
    return {"norm1": common.init_norm(cfg, cfg.d_model, dev),
            "tmix": rwkv6.init_rwkv6(cfg, gen),
            "norm2": common.init_norm(cfg, cfg.d_model, dev),
            "cmix": mlp.init_mlp(cfg, gen)}


def _init_mamba_block(cfg: ArchConfig, gen) -> dict:
    return {"norm1": common.init_norm(cfg, cfg.d_model, gen.device),
            "mamba": mamba2.init_mamba2(cfg, gen)}


def _ffn(p, h2, cfg: ArchConfig):
    """(the block's FFN of h2, the router's aux loss or None without a
    MoE)."""
    if _is_moe(cfg):
        return moe.apply_moe(p["moe"], h2, cfg)
    return mlp.apply_mlp(p["mlp"], h2, cfg), None


def _apply_attn_block(p, x, cfg: ArchConfig, positions, plain: bool):
    """Full-sequence attention block. Returns (x, aux); aux is None
    unless the FFN is a MoE."""
    h = common.apply_norm(p["norm1"], x, cfg)
    q, k, v = attention.qkv_proj(p["attn"], h, positions, cfg)
    attend = attention.attend_plain if plain else attention.attend
    att_out = attention.out_proj(p["attn"], attend(q, k, v, cfg), cfg)
    if cfg.parallel_block:
        return x + att_out + mlp.apply_mlp(p["mlp"], h, cfg), None
    x = x + att_out
    h2 = common.apply_norm(p["norm2"], x, cfg)
    y, aux = _ffn(p, h2, cfg)
    return x + y, aux


def _decode_attn_block(p, x, cache, pos: int, cfg: ArchConfig):
    """One decode step of the attention block: (x, cache); the MoE's aux
    is dropped, as the reference's ``decode_step`` drops it."""
    h = common.apply_norm(p["norm1"], x, cfg)
    att_out, cache = attention.decode_attend(p["attn"], h, cache, pos, cfg)
    if cfg.parallel_block:
        return x + att_out + mlp.apply_mlp(p["mlp"], h, cfg), cache
    x = x + att_out
    h2 = common.apply_norm(p["norm2"], x, cfg)
    return x + _ffn(p, h2, cfg)[0], cache


def _attn_block_rank(p, s, x, cfg: ArchConfig, positions, ranks,
                     plain: bool, sp: bool):
    """One rank's attention block: x this rank's residual rows (B, T/M,
    d) when ``sp``, else the whole sequence; each sublayer on the whole
    sequence, its output reduced back into the residual. Returns (x, the
    moe's aux or None)."""
    hf = ranks.seq_gather(common.apply_norm(p["norm1"], x, cfg), sp)
    a, ak = attention.apply_rank(p["attn"], s["attn"], hf, positions, cfg,
                                 ranks, plain)
    return _block_rest_rank(p, s, x, hf, a, ak, cfg, ranks, sp)


def _decode_block_rank(p, s, cs, x, cache, pos: int, cfg: ArchConfig,
                       ranks):
    """One rank's decode step of the attention block: (x, cache); the
    moe's aux is dropped, as in ``_decode_attn_block``."""
    h = common.apply_norm(p["norm1"], x, cfg)
    a, ak, cache = attention.decode_attend_rank(p["attn"], s["attn"], cs, h,
                                                cache, pos, cfg, ranks)
    return _block_rest_rank(p, s, x, h, a, ak, cfg, ranks, False)[0], cache


def _block_rest_rank(p, s, x, hf, a, ak: str, cfg: ArchConfig, ranks,
                     sp: bool):
    """The block past its attention ``a`` (of kind ``ak``): the MLP
    beside it on ``hf`` (parallel blocks) or the MLP or moe after it,
    each reduced into the residual ``x``. Returns (x, the moe's aux or
    None)."""
    if cfg.parallel_block:
        f, fk = mlp.apply_mlp_rank(p["mlp"], s["mlp"], hf, cfg, ranks)
        if ak == fk == "partial":           # one reduce-scatter for both
            return x + ranks.reduce(a + f, "partial", sp), None
        return x + ranks.reduce(a, ak, sp) + ranks.reduce(f, fk, sp), None
    x = x + ranks.reduce(a, ak, sp)
    h2 = ranks.seq_gather(common.apply_norm(p["norm2"], x, cfg), sp)
    aux = None
    if _is_moe(cfg):
        (f, fk), aux = moe.apply_moe_rank(p["moe"], s["moe"], h2, cfg, ranks)
    else:
        f, fk = mlp.apply_mlp_rank(p["mlp"], s["mlp"], h2, cfg, ranks)
    return x + ranks.reduce(f, fk, sp), aux


def _apply_rwkv_block(p, x, cfg: ArchConfig):
    h = common.apply_norm(p["norm1"], x, cfg)
    x = x + rwkv6.apply_rwkv6(p["tmix"], h, cfg)
    h2 = common.apply_norm(p["norm2"], x, cfg)
    h2_prev = torch.cat([torch.zeros_like(h2[:, :1]), h2[:, :-1]], dim=1)
    return x + mlp.apply_mlp(p["cmix"], h2, cfg, x_prev=h2_prev)


def _decode_rwkv_block(p, x, cache: rwkv6.RWKVCache, cfg: ArchConfig):
    h = common.apply_norm(p["norm1"], x, cfg)
    y, cache = rwkv6.decode_step(p["tmix"], h, cache, cfg)
    x = x + y
    h2 = common.apply_norm(p["norm2"], x, cfg)
    x = x + mlp.apply_mlp(p["cmix"], h2, cfg,
                          x_prev=cache.x_ffn[:, None].to(x.dtype))
    return x, cache._replace(x_ffn=h2[:, 0])


def _rwkv_block_rank(p, s, x, cfg: ArchConfig, ranks, sp: bool):
    """One rank's rwkv6 block: x its residual rows (``sp``) or the whole
    sequence; each mixer on the whole sequence, reduced into x."""
    hf = ranks.seq_gather(common.apply_norm(p["norm1"], x, cfg), sp)
    a, ak = rwkv6.apply_rwkv6_rank(p["tmix"], s["tmix"], hf, cfg, ranks)
    x = x + ranks.reduce(a, ak, sp)
    h2 = ranks.seq_gather(common.apply_norm(p["norm2"], x, cfg), sp)
    h2_prev = torch.cat([torch.zeros_like(h2[:, :1]), h2[:, :-1]], dim=1)
    f, fk = mlp.apply_mlp_rank(p["cmix"], s["cmix"], h2, cfg, ranks,
                               x_prev=h2_prev, sp=sp)
    return x + ranks.reduce(f, fk, sp)


def _decode_rwkv_block_rank(p, s, x, cache: rwkv6.RWKVCache,
                            cfg: ArchConfig, ranks):
    """One rank's decode step of the rwkv6 block: ``cache.S`` the state of
    its heads; (x, cache)."""
    h = common.apply_norm(p["norm1"], x, cfg)
    w = rwkv6.rank_weights(p["tmix"], s["tmix"], cfg, ranks)
    y, cache = rwkv6.decode_step(w, h, cache, cfg)
    kind = "partial" if ranks.on_model(s["tmix"]["w_o"], 0) else "full"
    x = x + ranks.reduce(y, kind, False)
    h2 = common.apply_norm(p["norm2"], x, cfg)
    f, fk = mlp.apply_mlp_rank(p["cmix"], s["cmix"], h2, cfg, ranks,
                               x_prev=cache.x_ffn[:, None].to(x.dtype))
    return x + ranks.reduce(f, fk, False), cache._replace(x_ffn=h2[:, 0])


def _mamba_block_rank(p, s, x, cfg: ArchConfig, ranks, plain: bool,
                      sp: bool):
    hf = ranks.seq_gather(common.apply_norm(p["norm1"], x, cfg), sp)
    y, kind = mamba2.apply_mamba2_rank(p["mamba"], s["mamba"], hf, cfg,
                                       ranks, plain)
    return x + ranks.reduce(y, kind, sp)


def _decode_mamba_block_rank(p, s, x, cache, cfg: ArchConfig, ranks):
    h = common.apply_norm(p["norm1"], x, cfg)
    y, kind, cache = mamba2.decode_step_rank(p["mamba"], s["mamba"], h,
                                             cache, cfg, ranks)
    return x + ranks.reduce(y, kind, False), cache


def _apply_mamba_block(p, x, cfg: ArchConfig, plain: bool):
    h = common.apply_norm(p["norm1"], x, cfg)
    forward = mamba2.apply_mamba2 if plain else mamba2.apply_mamba2_kernel
    return x + forward(p["mamba"], h, cfg)


def _decode_mamba_block(p, x, cache, cfg: ArchConfig):
    h = common.apply_norm(p["norm1"], x, cfg)
    y, cache = mamba2.decode_step(p["mamba"], h, cache, cfg)
    return x + y, cache


def _layer(fn, x, remat: bool):
    """``fn(x)`` (a tensor, or a tuple such as (x, aux)), checkpointed
    (recomputed in backward) under ``remat`` when autograd is
    recording."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _norm_axes(cfg: ArchConfig) -> dict:
    if cfg.norm_kind == "rmsnorm":
        return {"scale": (None,)}
    return {"scale": (None,), "bias": (None,)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """The reference's parameter tree on ``gen``'s device, with
    ``blocks`` as a list of per-layer dicts (any family of
    ``FAMILIES``); ``common.META`` gives it on ``meta``."""
    block_init = {"hybrid": _init_mamba_block,
                  "ssm": _init_rwkv_block}.get(cfg.family, _init_attn_block)
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


def _map_blocks(tree, fn):
    """``tree`` with ``fn`` applied to the subtree under every "blocks"
    key (params, optimizer moments and decode caches all have one)."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == "blocks" else _map_blocks(v, fn)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_blocks(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_blocks(v, fn) for v in tree)
    return tree


def stack_blocks(tree):
    """The reference's layout of a tree: each "blocks" list of per-layer
    trees becomes one tree of tensors stacked on a leading layers
    axis."""
    return _map_blocks(tree, lambda layers: tree_map(
        lambda *xs: torch.stack(xs), *layers)
        if isinstance(layers, list) else layers)


def stack_cache(cache: dict) -> dict:
    """The reference's stacked layout of a decode cache
    (``Model.init_decode_cache``'s per-layer lists): each list one cache
    of tensors stacked on a leading layers axis."""
    return {k: type(layers[0])(*(torch.stack(f) for f in zip(*layers)))
            for k, layers in cache.items()}


def unstack_cache(cache: dict) -> dict:
    """Inverse of ``stack_cache``: per-layer lists of views."""
    return {k: [type(c)(*(f[i] for f in c)) for i in range(len(c[0]))]
            for k, c in cache.items()}


def stacked_cache_specs(cfg: ArchConfig, shapes: dict, mesh) -> dict:
    """The plan's specs of a decode cache in the reference's stacked
    layout, from its shapes (``launch/steps.stacked_cache_shapes``), by
    the reference's rule of leaf ranks, which shards the layers axis of
    some leaves: the 4-dim stacked conv history takes the SSM state's
    axes (its batch over ``model``) and the 3-dim stacked token shifts
    the batch's (their layers over ``pod``, or ``data``, where it
    divides); a 5-dim leaf whose last dim is the head dim and whose
    third is past 8 takes the KV cache's (rwkv6's wkv state over its key
    dim)."""
    def leaf_spec(shp):
        if len(shp) == 4 and shp[1] > 1 and shp[3] == cfg.dim_per_head:
            lg = attention.cache_axes(shp[2], mesh)
        elif len(shp) == 5:
            # stacked (L, B, S, K, Dh) KV caches / (L,B,H,p,n) ssm states
            if shp[4] == cfg.dim_per_head and shp[2] > 8:
                lg = (None,) + attention.cache_axes(shp[3], mesh)
            else:
                lg = (None, "batch", "heads", None, None)
        elif len(shp) == 4:
            lg = ("batch", "heads", None, None)      # ssm state (B,H,p,n)
        elif len(shp) == 3:
            lg = ("batch", None, None)               # conv history (B,W,C)
        elif len(shp) == 2:
            lg = ("batch", None)                     # rwkv x_prev (B,d)
        else:
            lg = tuple(None for _ in shp)
        return partition.logical_to_physical(lg, mesh, shape=shp)

    return {k: type(c)(*(leaf_spec(tuple(s)) for s in c))
            for k, c in shapes.items()}


def unstack_blocks(tree):
    """Inverse of ``stack_blocks``: each "blocks" tree of stacked leaves
    (tensors or numpy arrays) becomes a list of per-layer trees (views
    of the stacked leaves)."""
    def unstack(stacked):
        if isinstance(stacked, list):
            return stacked
        n = len(tree_leaves(stacked)[0])
        return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]
    return _map_blocks(tree, unstack)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """A backbone of any family of ``FAMILIES``. ``device=None`` is the
    card (raises without one); ``device="cpu"`` runs the plain versions of
    the kernels; ``device="meta"`` builds shapes without storage (what the
    dry-run account traces). ``params`` (the reference's tree, ``blocks`` a list of
    per-layer dicts, as ``convert.model_params_from_jax`` gives it)
    replaces the seeded init. The moe family's expert layer is plain
    torch on every device (the reference computes it with einsums);
    its attention runs on the kernel like the dense family's."""

    def __init__(self, cfg: ArchConfig, device=None, params=None,
                 seed: int = 0):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}): "
                             f"the port builds {FAMILIES}")
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            gen = common.META if dev.type == "meta" else \
                torch.Generator(device=dev).manual_seed(seed)
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

    def param_tree(self) -> dict:
        """The reference's parameter tree (``blocks`` a list of per-layer
        dicts) of detached tensors sharing the module's storage: what
        ``hidden(..., params=)`` takes and the optimizer steps."""
        def tree(m):
            out = {k: tree(v) for k, v in m.named_children()}
            out.update((k, v.detach()) for k, v in
                       m.named_parameters(recurse=False))
            return out
        params = {"embedding": tree(self.embedding),
                  "blocks": [tree(b) for b in self.blocks],
                  "final_norm": tree(self.final_norm)}
        if self.cfg.shared_attn_every:
            params["shared"] = tree(self.shared)
        return params

    def logical_axes(self) -> dict:
        """A tree matching ``param_tree()`` with a tuple of logical axis
        names at each leaf (``sharding/partition.py`` maps them to a
        mesh). ``blocks`` is a list with one tree a layer; the
        reference's stacked block leaves carry a leading ``"layers"``
        axis instead."""
        cfg = self.cfg

        def block_axes(shared: bool):
            bcfg = shared_cfg(cfg) if shared else cfg
            if not shared and cfg.family == "ssm":
                return {"norm1": _norm_axes(cfg),
                        "tmix": rwkv6.logical_axes(cfg),
                        "norm2": _norm_axes(cfg),
                        "cmix": mlp.logical_axes(cfg)}
            if not shared and cfg.family == "hybrid":
                return {"norm1": _norm_axes(cfg),
                        "mamba": mamba2.logical_axes(cfg)}
            ax = {"norm1": _norm_axes(bcfg),
                  "attn": attention.logical_axes(bcfg)}
            if not bcfg.parallel_block:
                ax["norm2"] = _norm_axes(bcfg)
            if _is_moe(bcfg):
                ax["moe"] = moe.logical_axes(bcfg)
            else:
                ax["mlp"] = mlp.logical_axes(bcfg)
            return ax

        axes = {"embedding": common.logical_axes_embedding(cfg),
                "blocks": [block_axes(False) for _ in range(cfg.n_layers)],
                "final_norm": _norm_axes(cfg)}
        if cfg.shared_attn_every:
            axes["shared"] = block_axes(True)
        return axes

    # ----- full-sequence forward (train / prefill / embedding) -----

    def apply(self, batch: Dict[str, Any], plain: bool = False,
              remat: bool = False, params=None, mesh=None):
        """Returns (logits (B,T,V), aux dict)."""
        params = self.param_tree() if params is None else params
        if self.per_rank(mesh):
            return self._run_ranks(mesh, batch, "logits", plain, remat,
                                   params)
        h, aux = self.hidden(batch, plain=plain, remat=remat, params=params,
                             mesh=mesh)
        return common.unembed(params["embedding"], h, self.cfg), aux

    def hidden(self, batch: Dict[str, Any], plain: bool = False,
               remat: bool = False, params=None, mesh=None):
        """Final normed hidden states (B,T,d) + aux — callers that want
        memory-bounded losses unembed in sequence chunks themselves.
        ``remat`` checkpoints each layer (and the shared block at each
        use) when autograd records; ``params`` (a ``param_tree()``-shaped
        tree) replaces the module's own weights. ``moe_aux`` is the
        moe family's router loss summed over layers (0 for the others);
        ``mesh`` as in the module docstring."""
        if self.per_rank(mesh):
            params = self.param_tree() if params is None else params
            return self._run_ranks(mesh, batch, "hidden", plain, remat,
                                   params)
        self._one_device(mesh)
        h, aux = self._backbone(batch, plain, remat, params)
        return h, {"moe_aux": aux}

    def _run_ranks(self, mesh, batch, what: str, plain: bool, remat: bool,
                   params):
        """``rank_map``'s output for ``apply`` / ``hidden``: (the logits
        or hidden states, {"moe_aux"}) as global values."""
        key = self.input_key(batch)
        inputs = {key: batch[key].to(self.device)}
        out = self.rank_map(mesh, inputs, what, plain, remat)(params,
                                                              inputs)
        if _is_moe(self.cfg):
            return out[0], {"moe_aux": out[1]}
        return out, {"moe_aux": torch.zeros((), device=self.device)}

    def embed_pool(self, batch: Dict[str, Any], plain: bool = False,
                   mesh=None):
        """Mean-pooled final hidden state (B, d_model) f32 — the embedding
        the DML metric head consumes."""
        h, _ = self.hidden(batch, plain=plain, mesh=mesh)
        return torch.mean(h.to(torch.float32), dim=1)

    def _backbone(self, batch, plain: bool, remat: bool, params):
        full_f32()          # f32 configs: true f32 products, as the reference
        cfg = self.cfg
        params = self.param_tree() if params is None else params
        x = self._embed_inputs(params, batch, getattr(torch, cfg.dtype))
        B, T, _ = x.shape
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        auxs = []
        if cfg.family == "hybrid":
            x = self._run_hybrid(params, x, positions, plain, remat)
        elif cfg.family == "ssm":
            for p_l in params["blocks"]:
                x = _layer(lambda x, p_l=p_l: _apply_rwkv_block(p_l, x, cfg),
                           x, remat)
        else:
            for p_l in params["blocks"]:
                x, aux = _layer(lambda x, p_l=p_l: _apply_attn_block(
                    p_l, x, cfg, positions, plain), x, remat)
                if aux is not None:
                    auxs.append(aux)
        # the reference sums the scan's stacked per-layer losses
        aux = torch.sum(torch.stack(auxs)) if auxs else \
            torch.zeros((), device=x.device)
        return common.apply_norm(params["final_norm"], x, cfg), aux

    def input_key(self, batch) -> str:
        """The batch's input: ``"embeddings"`` where the config takes
        them and the batch has them, else ``"tokens"`` (the reference's
        ``_embed_inputs`` rule)."""
        if self.cfg.input_kind == "embeddings" and "embeddings" in batch:
            return "embeddings"
        return "tokens"

    def _embed_inputs(self, params, batch, dtype):
        """The batch's frame / patch embeddings through ``frontend_proj``
        where the config takes them and the batch has them, else its
        tokens through the token embedding (the reference's rule)."""
        emb = params["embedding"]
        dev = emb["tok"].device
        if self.input_key(batch) == "embeddings":
            return common.embed_frontend(emb, batch["embeddings"].to(dev),
                                         self.cfg, dtype)
        return common.embed_tokens(emb, batch["tokens"].to(dev), self.cfg,
                                   dtype)

    def _run_hybrid(self, params, x, positions, plain: bool, remat: bool):
        """Zamba2: groups of mamba layers + the shared attention block."""
        cfg = self.cfg
        every = self._groups()[1]
        scfg = shared_cfg(cfg)
        blocks = params["blocks"]
        for g in range(self._groups()[0]):
            for p_l in blocks[g * every:(g + 1) * every]:
                x = _layer(lambda x, p_l=p_l: _apply_mamba_block(
                    p_l, x, cfg, plain), x, remat)
            x = _layer(lambda x: _apply_attn_block(
                params["shared"], x, scfg, positions, plain)[0], x,
                remat)
        return x

    def _groups(self):
        """(groups, layers a group) of the hybrid family."""
        cfg = self.cfg
        every = cfg.shared_attn_every
        if cfg.n_layers % every:
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple "
                             f"of shared_attn_every={every}")
        return cfg.n_layers // every, every

    # ----- decode -----

    def init_decode_cache(self, batch: int, max_seq: int, dtype=None,
                          device=None) -> dict:
        """Per-layer caches on ``device`` (the model's by default; "meta"
        gives shapes without storage): ``{"blocks": [KVCache
        | MambaCache | RWKVCache per layer]}``, and for the hybrid family
        ``"shared": [KVCache per group]`` (the shared block keeps one
        cache a use). KV caches, the conv history and the token shifts
        take ``dtype`` (``cfg.dtype`` by default); the SSM and wkv states
        are f32."""
        cfg = self.cfg
        if dtype is None:
            dtype = getattr(torch, cfg.dtype)
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        dev = self.device if device is None else torch.device(device)
        if cfg.family == "hybrid":
            n_groups = self._groups()[0]
            return {"blocks": [mamba2.init_cache(cfg, batch, dtype, dev)
                               for _ in range(cfg.n_layers)],
                    "shared": [attention.init_cache(shared_cfg(cfg), batch,
                                                    max_seq, dtype, dev)
                               for _ in range(n_groups)]}
        if cfg.family == "ssm":
            return {"blocks": [rwkv6.init_cache(cfg, batch, dtype, dev)
                               for _ in range(cfg.n_layers)]}
        return {"blocks": [attention.init_cache(cfg, batch, max_seq, dtype,
                                                dev)
                           for _ in range(cfg.n_layers)]}

    def decode_step(self, cache: dict, tokens, pos: int, mesh=None):
        """tokens (B,) or (B,1) int; ``pos`` a Python int (the current
        position, the same on every rank of a ``mesh``; the ssm family
        does not read it). Returns (logits (B,V), cache). KV caches are
        written in place and the SSM and wkv states replaced, so the
        cache passed in is spent: use the one returned."""
        full_f32()
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        tokens = tokens.to(self.device)
        if self.per_rank(mesh):
            if self.recurrent:
                cache = stack_cache(cache)
            run = self.rank_decode_map(mesh, cache, tokens.reshape(-1).shape,
                                       pos)
            logits, cache = run(self.param_tree(), cache, tokens.reshape(-1))
            return logits, unstack_cache(cache) if self.recurrent else cache
        self._one_device(mesh)
        if tokens.ndim == 1:
            tokens = tokens[:, None]
        x = common.embed_tokens(self.embedding, tokens, cfg, dtype)
        if cfg.family == "hybrid":
            x, new_cache = self._decode_hybrid(cache, x, pos)
        else:
            new_blocks = []
            for p_l, c_l in zip(self.blocks, cache["blocks"]):
                if cfg.family == "ssm":
                    x, c_l = _decode_rwkv_block(p_l, x, c_l, cfg)
                else:
                    x, c_l = _decode_attn_block(p_l, x, c_l, pos, cfg)
                new_blocks.append(c_l)
            new_cache = {"blocks": new_blocks}
        h = common.apply_norm(self.final_norm, x, cfg)
        logits = common.unembed(self.embedding, h, cfg)
        return logits[:, 0], new_cache

    def _decode_hybrid(self, cache, x, pos: int):
        cfg = self.cfg
        n_groups, every = self._groups()
        scfg = shared_cfg(cfg)
        blocks, shared = [], []
        for g in range(n_groups):
            for i in range(g * every, (g + 1) * every):
                x, c_l = _decode_mamba_block(self.blocks[i], x,
                                             cache["blocks"][i], cfg)
                blocks.append(c_l)
            x, sc = _decode_attn_block(self.shared, x, cache["shared"][g],
                                       pos, scfg)
            shared.append(sc)
        return x, {"blocks": blocks, "shared": shared}

    # ----- the per-rank program (on a live mesh) -----

    @staticmethod
    def per_rank(mesh) -> bool:
        """Whether ``mesh`` runs the per-rank program: a live mesh."""
        return isinstance(mesh, LiveMesh)

    @property
    def recurrent(self) -> bool:
        """Whether the decode cache is a recurrent family's (its per-rank
        decode map takes the cache stacked)."""
        return self.cfg.family in ("ssm", "hybrid")

    def _one_device(self, mesh):
        """Refuses a named ``mesh`` for the moe family, whose layers run
        expert-parallel only over a live one (its per-rank program on a
        named mesh runs in ``launch/mesh.fake_world``); the other
        families compute as without a mesh."""
        if mesh is not None and _is_moe(self.cfg):
            partition.require_live(mesh, "the moe family's expert map")

    def param_specs(self, mesh):
        """The sharding plan's specs of ``param_tree()`` on ``mesh``
        (``launch/steps.param_shardings``)."""
        return partition.make_param_shardings(self.logical_axes(), mesh,
                                              self.param_tree())

    def cache_specs(self, cache, mesh):
        """Specs of a decode cache (``init_decode_cache``'s per-layer
        list) on ``mesh``: the kv heads over ``model`` where they divide
        it, else the cache's sequence (``cache_seq``); the layers of
        ``launch/steps.cache_shardings``' stacked specs."""
        def spec(c):
            sp = partition.logical_to_physical(
                attention.cache_axes(c.k.shape[2], mesh), mesh,
                shape=tuple(c.k.shape))
            return type(c)(sp, sp)
        return {"blocks": [spec(c) for c in cache["blocks"]]}

    def _vocab_spec(self, specs, ranks):
        return "model" if common.vocab_block(
            self.cfg, specs["embedding"], ranks)[1] < self.cfg.vocab_size \
            else None

    def rank_hidden(self, params, specs, batch, ranks, plain: bool = True,
                    remat: bool = False):
        """(This rank's final-normed hidden states, whether they are its
        sequence-parallel rows (B, T/M, d) (else the whole sequence), the
        moe layers' summed aux or None), from its blocks of ``params``
        (the specs ``specs``) and of the batch's tokens (B, T) or frame /
        patch embeddings (B, T, d)."""
        full_f32()
        cfg = self.cfg
        key = self.input_key(batch)
        inp = batch[key]
        B, T = inp.shape[:2]
        sp = ranks.sp(T)
        embed = common.embed_frontend_rank if key == "embeddings" else \
            common.embed_tokens_rank
        x = embed(params["embedding"], specs["embedding"], inp, cfg,
                  getattr(torch, cfg.dtype), ranks, sp)
        positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
        auxs = []
        if cfg.family == "hybrid":
            x = self._rank_hybrid(params, specs, x, positions, ranks, plain,
                                  remat, sp)
        elif cfg.family == "ssm":
            for p_l, s_l in zip(params["blocks"], specs["blocks"]):
                x = _layer(lambda x, p_l=p_l, s_l=s_l: _rwkv_block_rank(
                    p_l, s_l, x, cfg, ranks, sp), x, remat)
        else:
            for p_l, s_l in zip(params["blocks"], specs["blocks"]):
                x, aux = _layer(lambda x, p_l=p_l, s_l=s_l: _attn_block_rank(
                    p_l, s_l, x, cfg, positions, ranks, plain, sp), x,
                    remat)
                if aux is not None:
                    auxs.append(aux)
        aux = torch.sum(torch.stack(auxs)) if auxs else None
        return common.apply_norm(params["final_norm"], x, cfg), sp, aux

    def _rank_hybrid(self, params, specs, x, positions, ranks, plain: bool,
                     remat: bool, sp: bool):
        """One rank's zamba2 groups: each mamba layer on the rank's heads,
        then the shared block on them; under ``remat`` each layer and each
        whole group checkpointed, as the reference's scans are."""
        cfg = self.cfg
        n_groups, every = self._groups()
        scfg = shared_cfg(cfg)

        def group(x, g):
            for i in range(g * every, (g + 1) * every):
                x = _layer(lambda x, i=i: _mamba_block_rank(
                    params["blocks"][i], specs["blocks"][i], x, cfg, ranks,
                    plain, sp), x, remat)
            return _attn_block_rank(params["shared"], specs["shared"], x,
                                    scfg, positions, ranks, plain, sp)[0]

        for g in range(n_groups):
            x = _layer(lambda x, g=g: group(x, g), x, remat)
        return x

    def rank_logits(self, params, specs, h, ranks, sp: bool):
        """This rank's logits (B, T, V / M) of its hidden states ``h``."""
        return common.unembed_rank(params["embedding"], specs["embedding"],
                                   ranks.seq_gather(h, sp), self.cfg, ranks)

    def rank_map(self, mesh, batch, what: str = "logits",
                 plain: bool = True, remat: bool = False):
        """The per-rank forward as a ``partition.shard_map`` over
        (params, batch) for batches shaped as ``batch`` (``{"tokens":
        (B, T)}`` or ``{"embeddings": (B, T, d)}``): the logits, or with
        ``what="hidden"`` the final-normed hidden states, as global
        values, and for the moe family with its ``moe_aux`` beside them
        (``run.body`` is the per-rank program on blocks)."""
        ranks = common.Ranks(mesh)
        specs = self.param_specs(mesh)
        key = self.input_key(batch)
        shape = tuple(batch[key].shape)
        bspec = partition.logical_to_physical(
            ("batch", "seq", None)[:len(shape)], mesh, shape=shape)
        with_aux = _is_moe(self.cfg)

        def body(params, batch):
            h, sp, aux = self.rank_hidden(params, specs, batch, ranks,
                                          plain, remat)
            out = h if what == "hidden" else \
                self.rank_logits(params, specs, h, ranks, sp)
            return (out, aux) if with_aux else out

        if what == "hidden":
            out = (bspec[0], "model" if ranks.sp(shape[1]) else None, None)
        else:
            out = (bspec[0], None, self._vocab_spec(specs, ranks))
        return partition.shard_map(
            body, mesh, in_specs=(specs, {key: bspec}),
            out_specs=(out, ()) if with_aux else out)

    def rank_decode(self, params, specs, cspecs, cache, tokens, pos: int,
                    ranks):
        """This rank's decode step: (logits (B, V / M), cache) from its
        blocks of ``params``, of the cache (the specs ``cspecs``, written
        in place) and of ``tokens`` (B,)."""
        full_f32()
        cfg = self.cfg
        x = common.embed_tokens_rank(params["embedding"],
                                     specs["embedding"], tokens[:, None],
                                     cfg, getattr(torch, cfg.dtype), ranks,
                                     False)
        if cfg.family == "hybrid":
            x, new = self._rank_decode_hybrid(params, specs, cspecs, cache,
                                              x, pos, ranks)
        else:
            blocks = []
            for p_l, s_l, c_l, cs_l in zip(params["blocks"],
                                           specs["blocks"], cache["blocks"],
                                           cspecs["blocks"], strict=True):
                if cfg.family == "ssm":
                    x, c_l = _decode_rwkv_block_rank(p_l, s_l, x, c_l, cfg,
                                                     ranks)
                else:
                    x, c_l = _decode_block_rank(p_l, s_l, cs_l, x, c_l, pos,
                                                cfg, ranks)
                blocks.append(c_l)
            new = {"blocks": blocks}
        h = common.apply_norm(params["final_norm"], x, cfg)
        return self.rank_logits(params, specs, h, ranks, False)[:, 0], new

    def _rank_decode_hybrid(self, params, specs, cspecs, cache, x, pos: int,
                            ranks):
        cfg = self.cfg
        n_groups, every = self._groups()
        blocks, shared = [], []
        for g in range(n_groups):
            for i in range(g * every, (g + 1) * every):
                x, c = _decode_mamba_block_rank(
                    params["blocks"][i], specs["blocks"][i], x,
                    cache["blocks"][i], cfg, ranks)
                blocks.append(c)
            x, c = _decode_block_rank(params["shared"], specs["shared"],
                                      cspecs["shared"][g], x,
                                      cache["shared"][g], pos,
                                      shared_cfg(cfg), ranks)
            shared.append(c)
        return x, {"blocks": blocks, "shared": shared}

    def _working_cache_specs(self, shapes, specs, tspec, mesh) -> dict:
        """The layout a rank decodes a recurrent family's stacked cache in:
        the batch as the tokens', the SSM and wkv states over the rank's
        heads, the conv history and token shifts whole over the rest, the
        shared block's kv caches as the attention families' (over kv heads
        or ``cache_seq``)."""
        b = tspec[0]
        if self.cfg.family == "ssm":
            split = common.Ranks.on_model(specs["blocks"][0]["tmix"]["u"], 0)
            return {"blocks": rwkv6.RWKVCache(
                (None, b, "model" if split else None, None, None),
                (None, b, None), (None, b, None))}
        split = common.Ranks.on_model(specs["blocks"][0]["mamba"]["w_z"], 1)
        kshape = tuple(shapes["shared"].k[1:])
        kv = (None,) + partition.logical_to_physical(
            attention.cache_axes(kshape[2], mesh), mesh, shape=kshape)
        return {"blocks": mamba2.MambaCache(
            (None, b, "model" if split else None, None, None),
            (None, b, None, None)),
            "shared": attention.KVCache(kv, kv)}

    def _recurrent_decode_body(self, mesh, cache, specs, tspec, pos: int,
                               ranks):
        """(the plan's specs of the stacked ``cache``, the per-rank decode
        body over it): each leaf moved to its working layout, decoded
        layer by layer, and moved back. The conv history moves back only
        its newest entry (the rest is its old block, shifted); the shared
        block's kv caches are written in place."""
        shapes = {k: type(c)(*(tuple(t.shape) for t in c))
                  for k, c in cache.items()}
        plan = stacked_cache_specs(self.cfg, shapes, mesh)
        work = self._working_cache_specs(shapes, specs, tspec, mesh)
        layer = {k: [type(c)(*(sp[1:] for sp in c))] * shapes[k][0][0]
                 for k, c in work.items()}

        def move(c, src, dst):
            return type(c)(*(partition.reblock(t, a, b, mesh)
                             for t, a, b in zip(c, src, dst)))

        def body(params, cache, tokens):
            local = {k: move(c, plan[k], work[k]) for k, c in cache.items()}
            logits, new = self.rank_decode(params, specs, layer,
                                           unstack_cache(local), tokens, pos,
                                           ranks)
            blocks = stack_cache({"blocks": new["blocks"]})["blocks"]
            if self.cfg.family == "ssm":
                return logits, {"blocks": move(blocks, work["blocks"],
                                               plan["blocks"])}
            newest = partition.reblock(blocks.conv[:, :, -1:],
                                       work["blocks"].conv,
                                       plan["blocks"].conv, mesh)
            return logits, {
                "blocks": mamba2.MambaCache(
                    partition.reblock(blocks.h, work["blocks"].h,
                                      plan["blocks"].h, mesh),
                    torch.cat([cache["blocks"].conv[:, :, 1:], newest],
                              dim=2)),
                "shared": move(local["shared"], work["shared"],
                               plan["shared"])}

        return plan, body

    def rank_decode_map(self, mesh, cache, tokens_shape, pos: int):
        """The per-rank decode step at ``pos`` as a ``partition.shard_map``
        over (params, cache, tokens): (logits, cache) as global values. A
        recurrent family's ``cache`` is stacked (``stack_cache``)."""
        ranks = common.Ranks(mesh)
        specs = self.param_specs(mesh)
        tspec = partition.logical_to_physical(("batch",), mesh,
                                              shape=tuple(tokens_shape))
        if self.recurrent:
            cspecs, body = self._recurrent_decode_body(mesh, cache, specs,
                                                       tspec, pos, ranks)
            return partition.shard_map(
                body, mesh, in_specs=(specs, cspecs, tspec),
                out_specs=((tspec[0], self._vocab_spec(specs, ranks)),
                           cspecs))
        cspecs = self.cache_specs(cache, mesh)

        def body(params, cache, tokens):
            return self.rank_decode(params, specs, cspecs, cache, tokens,
                                    pos, ranks)

        return partition.shard_map(
            body, mesh, in_specs=(specs, cspecs, tspec),
            out_specs=((tspec[0], self._vocab_spec(specs, ranks)), cspecs))
