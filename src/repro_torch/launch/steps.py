"""Step builders + shape records for train / prefill / decode
(counterpart of ``repro/launch/steps.py``).

``input_specs`` and ``cache_shape_structs`` describe a step's inputs and
decode cache as ``meta`` tensors (shape and dtype, no storage); the
``make_*_step`` functions return plain callables over a ``TrainState``
(train) or a ``Model`` (prefill, decode). The sharding functions
(``batch_pspec``, ``input_shardings``, ``param_shardings``,
``make_state_shardings``, ``cache_logical_axes``, ``cache_shardings``)
return the reference's plans as specs (``sharding/partition.py``);
``make_state_shardings`` on a live mesh returns them as
``partition.NamedSharding`` pairs, which ``checkpoint.restore_checkpoint``
places leaves by.

The step builders take the reference's ``mesh=``. On a live mesh every
family runs the whole step per rank, in one ``partition.shard_map`` over
the plan's specs (``param_shardings``,
``make_state_shardings``, ``input_shardings``, ``cache_shardings``): the
model's per-rank program (``Model.rank_hidden``, tokens or frame / patch
embeddings in; the moe layers expert-parallel inside it), the
cross-entropy over vocab-sharded logits (``chunked_ce_loss_rank``: the
max and the sum of exp over ``model``; a vocab that does not divide
``model``, hubert's 504 on 16, stays whole on every rank) plus
``moe_aux_weight`` times the moe layers' aux, the gradients of FSDP
leaves reduce-scattered over ``data`` by their gathers' backward and
every leaf's partials psummed over the axes it is replicated on,
``clip_by_global_norm`` on psummed squared norms and AdamW on the
shards. The step takes and returns global values; ``rank_train_map``
gives the map, whose ``body`` the dry run traces on one rank's blocks.

The training forward is ``Model.hidden(..., plain=True)``: the
reference's own training forms (chunked SSD, chunked rwkv6, naive or
chunked attention); the two backbone kernels are forward-only. Parameters,
gradients and optimizer states are the reference-shaped trees of
``Model.param_tree()``, and the optimizer is the port's functional
``optim``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, InputShape, RunConfig
from repro_torch.core import losses
from repro_torch.launch.mesh import LiveMesh, Mesh
from repro_torch.models import attention, common
from repro_torch.models.transformer import Model, stacked_cache_specs
from repro_torch.optim import (Optimizer, adam, adamw, apply_updates,
                               clip_by_global_norm, momentum, schedules, sgd)
from repro_torch.sharding import partition
from repro_torch.sharding.partition import (Spec, logical_to_physical,
                                            make_param_shardings, named)
from repro_torch.tree import tree_leaves, tree_map, value_and_grad


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def make_optimizer(run: RunConfig) -> Optimizer:
    lr = schedules.cosine(run.lr, run.total_steps, warmup=run.warmup)
    if run.opt == "adamw":
        return adamw(lr, weight_decay=run.weight_decay)
    if run.opt == "adam":
        return adam(lr)
    if run.opt == "sgd":
        return sgd(lr)
    if run.opt == "momentum":
        return momentum(lr)
    raise ValueError(run.opt)


def init_train_state(model: Model, opt: Optimizer) -> TrainState:
    """The model's weights (``param_tree()``), a fresh optimizer state
    and step 0, on the model's device."""
    params = model.param_tree()
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32,
                                  device=model.device))


# ---------------------------------------------------------------------------
# Effective config per (arch, shape): long-context needs sub-quadratic attn.
# ---------------------------------------------------------------------------

def effective_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Dense/MoE/VLM archs switch to the sliding-window variant for the
    524k-token decode shape (DESIGN.md §5); SSM/hybrid run natively."""
    if (shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            and cfg.attention == "full"):
        return cfg.replace(attention="sliding", window=4096)
    return cfg


def skip_reason(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    if shape.mode == "decode" and not cfg.has_decode:
        return "encoder-only architecture: no autoregressive decode step"
    return None


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no storage)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """Model inputs for one step, as meta tensors."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.mode == "train":
        if cfg.input_kind == "embeddings":
            return {"embeddings": _spec((B, T, cfg.d_model),
                                        getattr(torch, cfg.dtype)),
                    "labels": _spec((B, T), i32)}
        return {"tokens": _spec((B, T), i32), "labels": _spec((B, T), i32)}
    if shape.mode == "prefill":
        if cfg.input_kind == "embeddings":
            return {"embeddings": _spec((B, T, cfg.d_model),
                                        getattr(torch, cfg.dtype))}
        return {"tokens": _spec((B, T), i32)}
    if shape.mode == "decode":
        return {"tokens": _spec((B,), i32), "pos": _spec((), i32)}
    raise ValueError(shape.mode)


def batch_pspec(name: str, mesh: Mesh, spec_tensor) -> Spec:
    """Spec for one input leaf: batch dim over (pod, data)."""
    logical = {
        "tokens": ("batch",) if len(spec_tensor.shape) == 1
        else ("batch", "seq"),
        "labels": ("batch", "seq"),
        "embeddings": ("batch", "seq", None),
        "pos": (),
    }[name]
    return logical_to_physical(logical, mesh, shape=tuple(spec_tensor.shape))


def input_shardings(specs, mesh: Mesh):
    return {k: batch_pspec(k, mesh, v) for k, v in specs.items()}


# ---------------------------------------------------------------------------
# Parameter / state shardings
# ---------------------------------------------------------------------------

def param_shardings(model: Model, params, mesh: Mesh):
    """Specs for the param tree (``model.param_tree()``'s layout: blocks
    a list of per-layer trees) from the model's logical axes."""
    return make_param_shardings(model.logical_axes(), mesh, params)


def _stacked(tree, specs, out, layers=0):
    """(shape, spec) of ``tree``'s leaves in the reference's layout and
    leaf order: dict keys sorted, and each "blocks" list one tree whose
    leaves carry a leading layers axis (replicated)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if k == "blocks" and isinstance(tree[k], list):
                _stacked(tree[k][0], specs[k][0], out, len(tree[k]))
            else:
                _stacked(tree[k], specs[k], out, layers)
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            _stacked(t, s, out, layers)
    else:
        lead = (layers,) if layers else ()
        out.append((lead + tuple(tree.shape),
                    ((None,) if layers else ()) + tuple(specs)))
    return out


def make_state_shardings(state: "TrainState", params, pshard,
                         mesh: Mesh) -> "TrainState":
    """Shard TrainState: params as given; opt moment buffers mirror params
    by shape; scalars replicated. The match by shape runs as the
    reference's does, on its stacked layout and leaf order, so each
    moment takes the reference's spec (a moment of a block leaf matches
    the first parameter of its stacked shape, which need not be the
    leaf it mirrors). On a live mesh the specs come back as
    ``NamedSharding`` pairs on it."""
    index = _stacked(params, pshard, [])

    def match(leaf, layers):
        if leaf.ndim == 0:
            return ()
        shape = ((layers,) if layers else ()) + tuple(leaf.shape)
        for shp, spec in index:
            if shp == shape:
                return spec[1:] if layers else spec
        return ()

    def walk(tree, layers=0):
        if isinstance(tree, dict):
            return {k: [walk(v, len(tree[k])) for v in tree[k]]
                    if k == "blocks" and isinstance(tree[k], list)
                    else walk(tree[k], layers) for k in tree}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(t, layers) for t in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(t, layers) for t in tree)
        return match(tree, layers)

    specs = TrainState(params=pshard, opt_state=walk(state.opt_state),
                       step=())
    return named(mesh, specs) if isinstance(mesh, LiveMesh) else specs


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def chunked_ce_loss(model: Model, params, h, labels, n_chunks: int = 8):
    """Cross-entropy with seq-chunked unembedding (bounds live logits to
    (B, T/n_chunks, V)); each chunk's logits are recomputed in backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    cfg = model.cfg
    B, T, d = h.shape
    while T % n_chunks != 0:
        n_chunks -= 1
    Tc = T // n_chunks

    def chunk_loss(h_k, l_k):
        logits = common.unembed(params["embedding"], h_k, cfg)
        return losses.softmax_cross_entropy(logits, l_k)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        h_k, l_k = h[:, c * Tc:(c + 1) * Tc], labels[:, c * Tc:(c + 1) * Tc]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_loss, h_k, l_k,
                                       use_reentrant=False)
        else:
            total = total + chunk_loss(h_k, l_k)
    return total / n_chunks


def chunked_ce_loss_rank(model: Model, params, specs, h, labels, ranks,
                         sp: bool, n_chunks: int = 8):
    """``chunked_ce_loss`` on one rank: ``h`` its final hidden states
    (its sequence-parallel rows when ``sp``), ``labels`` (B, T) its
    batch's; the logits of each chunk over this rank's vocab block, the
    max and the sum of exp taken over ``model`` (the label's logit from
    the rank whose block holds it). The mean over this rank's tokens,
    the same on every ``model`` rank. A vocab that does not divide
    ``model`` is whole on every rank, so each computes the whole
    cross-entropy: it is pmeaned over ``model`` (its value unchanged),
    so that its gradient counts once when the partials are summed."""
    cfg, mesh = model.cfg, ranks.mesh
    hf = ranks.seq_gather(h, sp)
    T = hf.shape[1]
    while T % n_chunks != 0:
        n_chunks -= 1
    Tc = T // n_chunks
    w = common.unembed_weight(params["embedding"], specs["embedding"], cfg,
                              ranks)
    v0, V_l = common.vocab_block(cfg, specs["embedding"], ranks)

    def chunk_loss(h_k, l_k, w):
        logits = (h_k @ w.to(h_k.dtype)).to(torch.float32)
        if V_l == cfg.vocab_size:
            return losses.softmax_cross_entropy(logits, l_k)
        m = partition.pmax(torch.amax(logits, dim=-1), "model", mesh)
        local = l_k.long() - v0
        inside = (local >= 0) & (local < V_l)
        ll = torch.gather(logits, -1, local.clamp(0, V_l - 1)[..., None])
        ll = torch.where(inside, ll[..., 0], torch.zeros_like(m))
        se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        se, ll = partition.psum((se, ll), "model", mesh)
        return torch.mean(torch.log(se) + m - ll)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        h_k, l_k = hf[:, c * Tc:(c + 1) * Tc], labels[:, c * Tc:(c + 1) * Tc]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_loss, h_k, l_k, w,
                                       use_reentrant=False)
        else:
            total = total + chunk_loss(h_k, l_k, w)
    if V_l == cfg.vocab_size and ranks.model:
        return partition.pmean(total / n_chunks, "model", mesh)
    return total / n_chunks


def _replicated_on(spec, mesh):
    """The mesh axes a leaf of ``spec`` is replicated on."""
    named = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    return tuple(a for a in mesh.axis_names if a not in named)


def sum_partials(grads, specs, mesh):
    """Each gradient leaf summed over the mesh axes its spec replicates
    it on (one psum for the leaves of each set of axes): every rank's
    partial of a replicated leaf, the batch axes' of an FSDP leaf (whose
    gather's backward already reduce-scattered it over ``data``)."""
    pairs = partition.spec_leaves(grads, specs)
    leaves = [g for g, _ in pairs]
    axes = [_replicated_on(s, mesh) for _, s in pairs]
    out = list(leaves)
    for group in dict.fromkeys(axes):
        idx = [i for i, a in enumerate(axes) if a == group]
        if not group or mesh.axis_size(group) == 1:
            continue
        summed = partition.psum([leaves[i] for i in idx], group, mesh)
        for i, g in zip(idx, summed):
            out[i] = g
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def clip_by_global_norm_rank(grads, specs, mesh, max_norm: float):
    """``clip_by_global_norm`` over sharded gradients: each leaf's
    squared norm over its replicas' count, psummed over the mesh (one
    scalar all-reduce)."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             / mesh.axis_size(_replicated_on(s, mesh))
             for g, s in partition.spec_leaves(grads, specs))
    gn = torch.sqrt(partition.psum(sq, mesh.axis_names, mesh))
    scale = torch.clamp_max(max_norm / (gn + 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), gn


def _relayout(tree, src, dst, mesh):
    """Each leaf of ``tree`` (blocks under the spec tree ``src``) as its
    block under ``dst`` (``partition.reblock``). The reference's AdamW
    moments take the spec of the first parameter of their stacked shape
    (``make_state_shardings``), and the update runs on the moments'
    blocks: hubert's norm scales and biases share (layers, d) with
    ``bo``, so their moments are sharded over ``data`` while the leaves
    are replicated; rwkv6's time-mix projections share (layers, d, d)
    with the channel mix's ``w_r`` (``("data", None)``), so the moments
    of ``w_o`` (``("model", "data")``) move ``data`` from one dimension
    to the other; zamba2's shared ``b_down`` (``("data",)``) shares (d,)
    with the norm scales, whose moments are replicated."""
    pairs = zip(partition.spec_leaves(tree, src),
                partition.spec_leaves(tree, dst))
    it = iter([x if a == b else partition.reblock(x, a, b, mesh)
               for (x, a), (_, b) in pairs])
    return tree_map(lambda _: next(it), tree)


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _rank_loss(model: Model, specs, ranks, remat: bool, loss_chunks: int):
    """The per-rank loss over this rank's blocks (params under
    ``specs``, the batch under ``input_shardings``): the cross-entropy
    over vocab-sharded logits, the mean over the batch shards, plus
    ``moe_aux_weight`` times the moe layers' aux; (loss, {"ce",
    "moe_aux"}), the same on every rank."""
    mesh = ranks.mesh
    n_batch = mesh.axis_size(ranks.batch) if ranks.batch else 1

    def loss_fn(params, batch):
        h, sp, aux = model.rank_hidden(params, specs, batch, ranks,
                                       plain=True, remat=remat)
        ce = chunked_ce_loss_rank(model, params, specs, h, batch["labels"],
                                  ranks, sp, loss_chunks)
        ce = partition.psum(ce / n_batch, ranks.batch, mesh)
        if aux is None:
            return ce, {"ce": ce, "moe_aux": torch.zeros_like(ce)}
        return ce + model.cfg.moe_aux_weight * aux, {"ce": ce,
                                                     "moe_aux": aux}

    return loss_fn


def train_loss(model: Model, params, batch, mesh=None, remat: bool = False,
               loss_chunks: int = 8):
    """``make_train_step``'s loss of ``params`` (a ``param_tree()``-shaped
    tree) on ``batch``: (the reference's ce + moe_aux_weight * moe_aux,
    {"ce", "moe_aux"}). On a live ``mesh`` it is computed per rank (the
    step's own loss, in one ``partition.shard_map`` over global values);
    otherwise through ``Model.hidden`` and ``chunked_ce_loss``."""
    if model.per_rank(mesh):
        specs = model.param_specs(mesh)
        return partition.shard_map(
            _rank_loss(model, specs, common.Ranks(mesh), remat, loss_chunks),
            mesh, in_specs=(specs, input_shardings(batch, mesh)),
            out_specs=((), ()))(params, batch)
    h, aux = model.hidden(batch, plain=True, remat=remat, params=params,
                          mesh=mesh)
    ce = chunked_ce_loss(model, params, h, batch["labels"], loss_chunks)
    total = ce + model.cfg.moe_aux_weight * aux["moe_aux"]
    return total, {"ce": ce, "moe_aux": aux["moe_aux"]}


def rank_train_map(model: Model, opt: Optimizer, run: RunConfig, mesh,
                   batch, loss_chunks: int = 8):
    """The train step for batches shaped as ``batch`` as one per-rank
    ``partition.shard_map`` over (state, batch) (the module docstring);
    its ``body`` takes this rank's blocks. The loss is ``_rank_loss``,
    the reference's: the cross-entropy plus ``moe_aux_weight`` times the
    moe layers' aux."""
    specs = model.param_specs(mesh)
    meta = _meta(model.param_tree())
    sshard = make_state_shardings(
        TrainState(meta, opt.init(meta), torch.zeros((), device="meta")),
        meta, specs, Mesh(mesh.axis_names, mesh.axis_sizes))
    loss_fn = _rank_loss(model, specs, common.Ranks(mesh), run.remat,
                         loss_chunks)
    # the specs of the optimizer's moments (AdamW's m, momentum's mu)
    mspecs = getattr(sshard.opt_state, "m",
                     getattr(sshard.opt_state, "mu", specs))

    def body(state: TrainState, batch):
        (loss, aux), grads = value_and_grad(loss_fn, state.params, batch)
        grads = sum_partials(grads, specs, mesh)
        if run.grad_clip:
            grads, gnorm = clip_by_global_norm_rank(grads, specs, mesh,
                                                    run.grad_clip)
        else:
            gnorm = torch.zeros((), device=loss.device)
        with torch.no_grad():
            updates, opt_state = opt.update(
                _relayout(grads, specs, mspecs, mesh), state.opt_state,
                _relayout(state.params, specs, mspecs, mesh))
            params = apply_updates(state.params,
                                   _relayout(updates, mspecs, specs, mesh))
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return TrainState(params, opt_state, state.step + 1), metrics

    return partition.shard_map(
        body, mesh, in_specs=(sshard, input_shardings(batch, mesh)),
        out_specs=(sshard, ()))


def _by_shapes(build):
    """A step that builds its per-rank map for each set of input shapes
    once (``build(*args)``), and runs it on the arguments."""
    maps = {}

    def step(*args):
        key = tuple(tuple(t.shape) for t in tree_leaves(args[-1]))
        if key not in maps:
            maps[key] = build(*args)
        return maps[key](*args)

    return step


def make_train_step(model: Model, opt: Optimizer, run: RunConfig,
                    mesh=None, loss_chunks: int = 8):
    """``train_step(state, batch) -> (state, metrics)``: loss, grads with
    respect to every leaf of ``state.params``, global-norm clipping,
    the optimizer's update. Returns new tensors; ``state`` is left as it
    was. Metrics are 0-d tensors (no host sync in the step). Over a live
    ``mesh`` every rank calls it with the same state and global batch."""
    if model.per_rank(mesh):
        return _by_shapes(lambda state, batch: rank_train_map(
            model, opt, run, mesh, batch, loss_chunks))

    def loss_fn(params, batch):
        return train_loss(model, params, batch, mesh, run.remat, loss_chunks)

    def train_step(state: TrainState, batch):
        (loss, aux), grads = value_and_grad(loss_fn, state.params, batch)
        if run.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        else:
            gnorm = torch.zeros((), device=loss.device)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_prefill_step(model: Model, run: RunConfig, mesh=None):
    """``prefill_step(batch) -> logits`` on the model's weights (per rank
    on a live mesh: ``Model.rank_map``)."""
    def prefill_step(batch):
        logits, aux = model.apply(batch, mesh=mesh)
        return logits

    return prefill_step


def make_serve_step(model: Model, run: RunConfig, mesh=None):
    def serve_step(cache, batch):
        return model.decode_step(cache, batch["tokens"], batch["pos"],
                                 mesh=mesh)

    return serve_step


# ---------------------------------------------------------------------------
# Cache shapes for decode shapes
# ---------------------------------------------------------------------------

def cache_shape_structs(model: Model, shape: InputShape):
    """The decode cache as meta tensors (no allocation): per-layer lists
    as ``Model.init_decode_cache`` makes them."""
    return model.init_decode_cache(shape.global_batch, shape.seq_len,
                                   device="meta")


def cache_logical_axes(cfg: ArchConfig, mesh: Mesh):
    """Logical axes for cache leaves, chosen per divisibility:
    KV caches (B, S, K, Dh): shard K over model if divisible, else shard S
    (flash-decoding); SSM states shard heads over model."""

    def kv_axes(leaf_shape):
        return attention.cache_axes(leaf_shape[2], mesh)

    return kv_axes


def stacked_cache_shapes(cache: dict) -> dict:
    """The reference's layout of a decode cache (``Model.init_decode_cache``'s
    per-layer lists): each list one cache whose leaves carry a leading
    axis of the list's length, as shape tuples."""
    return {k: type(layers[0])(*(
        (len(layers),) + tuple(leaf.shape) for leaf in layers[0]))
        for k, layers in cache.items()}


def cache_shardings(model: Model, cfg: ArchConfig, shape: InputShape,
                    mesh: Mesh) -> dict:
    """Specs of the decode cache in the reference's stacked layout
    (``stacked_cache_shapes``; ``transformer.stack_blocks`` stacks a
    cache so), by ``transformer.stacked_cache_specs``' rule."""
    return stacked_cache_specs(
        cfg, stacked_cache_shapes(cache_shape_structs(model, shape)), mesh)
