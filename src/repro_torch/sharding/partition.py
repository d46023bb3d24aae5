"""Logical-axis sharding rules with divisibility-checked fallback
(counterpart of ``repro/sharding/partition.py``).

Model code names parameter and activation dimensions with *logical* axes
("embed", "heads", "ffn", "vocab", "experts", "batch", "seq", ...). A
rule table maps logical axes to the axes of a mesh
(``launch/mesh.Mesh``); ``logical_to_physical`` drops any mapping whose
dimension does not divide the mesh axis (yi-6b's 4 KV heads on a model
axis of 16 are replicated), so every config has a plan on every mesh.

A spec is a tuple with one entry a tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names, equal entry
for entry to the reference's ``PartitionSpec``. ``local_shape`` gives
one rank's shard; ``NamedSharding(mesh, spec)`` is the reference's pair
of the two, which ``checkpoint.restore_checkpoint`` places leaves by.

Over a live mesh (``launch/mesh.LiveMesh``, one process a rank) a global
tensor is the same on every rank and a sharded one is held as this
rank's block: ``block`` / ``constrain`` take this rank's block of a
global tensor, and the axis collectives ``psum``, ``pmean``, ``pmax``,
``all_gather``, ``psum_scatter``, ``all_to_all``, ``pvary`` and
``axis_index`` are the counterparts of ``jax.lax``'s inside a
``shard_map`` body, each issued as the collective of its kind
(all-reduce, all-gather, reduce-scatter, all-to-all), so that
the dry-run account (``launch/cost_analysis.py``) counts what production
issues. On a named shape (``Mesh``) there is no group, and ``constrain``
/ ``shard_map`` raise: a named mesh's per-rank program runs inside
``launch/mesh.fake_world``.

``shard_map`` follows ``jax.shard_map``: its ``run`` takes and returns
global values. The body sees this rank's blocks; each output comes back
gathered over the axes its out spec names, and under ``()`` as the
value this rank holds (the body must make it the same on every rank).
``run.body`` is the body itself, on blocks in and blocks out (with
``run.in_specs`` / ``run.out_specs``): the per-rank program the dry run
traces. Gradients flow as the reference's do when the program outside
the map runs replicated on every rank, so that a cotangent arriving at
the map is the same on every rank:

  * ``psum``'s backward passes that replicated cotangent to each rank's
    partial unchanged (``pmean``'s divides it by the count). It is not
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces the cotangent and so counts a replicated one n times;
  * ``all_gather``'s backward is a reduce-scatter: the cotangent of a
    gathered value inside the body is a partial (a weight gathered for
    FSDP is used on each rank's own batch), so it is summed over the
    axis before this rank takes its slot; ``psum_scatter``'s backward is
    the all-gather of the cotangent of this rank's slot;
  * ``all_to_all``'s backward is the exchange back; ``pvary`` (the
    identity) all-reduces its cotangent: it marks a ``psum``'s sum that
    each rank goes on to use in its own way (a norm over features
    sharded over the axis), whose cotangents differ by rank;
  * the exit's gather takes this rank's slot of the replicated
    cotangent without a sum;
  * the entry sums each global input's gradient over the ranks: a
    rank's block holds its own share, and an input replicated over an
    axis holds each rank's partial. One all-reduce over the mesh a
    backward, of every input's zero-padded gradient.

So ``models/moe.apply_moe(mesh=)`` drops into a model that runs
replicated on every rank, and that model's gradients equal one
device's; a whole step run per rank (``launch/steps.py``) differentiates
inside the body, where the same rules give each rank its partial
gradients. Over gloo, an all-reduce of half-precision tensors is summed
in f32 and rounded once (a departure: the reference sums in their own
dtype; gloo's support for half-precision CUDA all-reduce is not relied
on); its all-gather and reduce-scatter take them as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import LiveMesh, Mesh
from repro_torch.tree import tree_leaves, tree_map

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default rule table for the production meshes (data, model) / (pod, data,
# model). Batch-like axes shard over data(+pod); weight axes over model.
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("pod", "data"),
    "pairs": ("pod", "data"),
    "workers": ("pod", "data"),
    "seq": None,
    # sequence-parallel residual: the inter-layer activation is sharded over
    # the model axis between blocks (Megatron-SP style) so deep stacks don't
    # hold O(layers * B * T * d) replicated residuals under remat
    "seq_sp": "model",
    # decode KV caches: shard the cache sequence dim over model when KV heads
    # don't divide the model axis (flash-decoding style partial softmax)
    "cache_seq": "model",
    # FSDP: weight embed dims shard over the data axis (ZeRO-3 style); XLA
    # all-gathers per layer and reduce-scatters gradients
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ffn": None,
    "heads_flat": "model",  # fused (H*Dh) output dims (rwkv r/k/v/g mats)
    "embed2": None,
    "proj": "model",        # DML: k rows of L
    "feat": None,           # DML: d columns of L
    "gallery": ("pod", "data"),  # serve: pre-projected gallery rows
    "neighbors": None,      # serve: per-query top-k result dim
    "state": None,          # SSM state dim
    "conv": None,
    "layers": None,         # scan-over-layers leading axis
}

_MULTI_GPU = ("needs a process group: enter launch/mesh.fake_world for a "
              "named mesh's per-rank program, or start ranks with "
              "launch/mesh.spawn")

# the two tensor collectives, by the names torch 2.13 gives them where it
# has them (the card's torch has the older ones only)
_all_gather_into = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_into = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


def _mesh_axis_size(mesh: Mesh, axis: Union[str, Tuple[str, ...]]) -> int:
    shape = mesh.shape
    if isinstance(axis, str):
        return shape[axis]
    n = 1
    for a in axis:
        n *= shape[a]
    return n


def logical_to_physical(logical: Sequence[Optional[str]], mesh: Mesh,
                        rules: Optional[dict] = None,
                        shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axis names to a spec, dropping non-dividing axes.

    Args:
      logical: one logical name (or None) per tensor dimension.
      mesh: target mesh; mappings to axes absent from the mesh are dropped.
      rules: overrides of DEFAULT_RULES.
      shape: if given, a mapping is kept only when shape[i] divides the mesh
        axis size (replicate otherwise).
    """
    table = dict(DEFAULT_RULES)
    if rules:
        table.update(rules)
    mshape = mesh.shape
    used = set()
    spec = []
    for i, name in enumerate(logical):
        phys = table.get(name) if name is not None else None
        if phys is None:
            spec.append(None)
            continue
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        axes = tuple(a for a in axes if a in mshape and a not in used)
        if not axes:
            spec.append(None)
            continue
        if shape is not None:
            size = _mesh_axis_size(mesh, axes)
            if shape[i] % size != 0:
                # try single-axis fallback before replicating entirely
                axes = tuple(a for a in axes if shape[i] % mshape[a] == 0)
                axes = axes[:1]
                if not axes:
                    spec.append(None)
                    continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def map_axes(fn, axes_tree, *rest):
    """Apply ``fn`` to each logical-axis tuple of ``axes_tree`` (dicts and
    lists of tuples) and the matching leaves of ``rest``."""
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        if any(len(r) != len(axes_tree) for r in rest):
            raise ValueError("trees of different lengths")
        return [map_axes(fn, *xs) for xs in zip(axes_tree, *rest)]
    return fn(axes_tree, *rest)


def make_param_shardings(logical_tree, mesh: Mesh, shapes_tree):
    """Map a tree of logical-axis tuples and a matching tree of tensors to
    specs. The port's trees keep ``blocks`` as a list of per-layer
    dicts."""
    return map_axes(
        lambda lg, t: logical_to_physical(lg, mesh, shape=tuple(t.shape)),
        logical_tree, shapes_tree)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh: Mesh) -> Tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` placed by ``spec``: each
    sharded dimension divided by the product of its mesh axes (a spec
    from ``logical_to_physical`` with ``shape`` divides exactly; a
    ragged one rounds up, as the largest shard)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for i, n in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            out.append(int(n))
            continue
        size = _mesh_axis_size(mesh, axes)
        out.append(-(-int(n) // size))
    return tuple(out)


def require_live(mesh, what: str) -> LiveMesh:
    if not isinstance(mesh, LiveMesh):
        raise NotImplementedError(f"{what} {_MULTI_GPU}: a live mesh "
                                  f"(launch/mesh.LiveMesh), not {mesh!r}")
    return mesh


def block(x: torch.Tensor, spec: Spec, mesh: LiveMesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` placed by ``spec`` (a
    view). A sharded dimension must divide its ranks."""
    mesh = require_live(mesh, "block")
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.axis_size(axes)
        if x.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(x.shape)} does not "
                             f"divide the {n} ranks of {axes}")
        step = x.shape[i] // n
        x = x.narrow(i, mesh.axis_index(axes) * step, step)
    return x


def _is_spec(s) -> bool:
    return type(s) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in s)


def map_specs(fn, specs):
    """``fn`` at each spec of a tree of specs (dicts, lists, NamedTuples
    and tuples of specs); ``None`` stays ``None``."""
    if specs is None:
        return None
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    out = [map_specs(fn, s) for s in specs]
    return type(specs)(*out) if hasattr(specs, "_fields") else \
        type(specs)(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s pair)."""

    mesh: Union[Mesh, LiveMesh]
    spec: Spec

    def place(self, x) -> torch.Tensor:
        """This rank's block of the global ``x`` on the mesh's device, a
        tensor of its own (not a view holding ``x``'s storage)."""
        mesh = require_live(self.mesh, "placing a tensor")
        return block(torch.as_tensor(x), self.spec, mesh).to(
            mesh.device, copy=True)


def named(mesh, specs):
    """A tree of specs as the same tree of ``NamedSharding`` on
    ``mesh``."""
    return map_specs(lambda s: NamedSharding(mesh, s), specs)


def _per_spec(fn, spec, tree):
    """``fn(leaf, spec)`` over a tree of tensors: ``spec`` mirrors the
    tree's dicts, NamedTuples and lists (a list for a plain tuple too),
    and a spec (a plain tuple; None for ``()``) covers the subtree under
    it."""
    if tree is None:
        return None
    if spec is None or _is_spec(spec):
        return tree_map(lambda x: fn(x, spec or ()), tree)
    if isinstance(tree, dict):
        return {k: _per_spec(fn, spec[k], v) for k, v in tree.items()}
    out = [_per_spec(fn, s, t) for s, t in zip(spec, tree, strict=True)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def spec_leaves(tree, specs):
    """(leaf, spec) of each tensor of ``tree`` in ``tree_leaves`` order,
    ``specs`` matched to it by key (their dicts' orders may differ)."""
    pairs = []
    _per_spec(lambda x, spec: pairs.append((x, spec)), specs, tree)
    return pairs


def _over_args(fn, tree, specs):
    """``_per_spec`` over ``tree``, or over each argument of a tuple of
    arguments with its own spec tree."""
    if type(tree) is tuple and type(specs) is tuple and not _is_spec(specs):
        return tuple(_per_spec(fn, s, t)
                     for s, t in zip(specs, tree, strict=True))
    return _per_spec(fn, specs, tree)


def local_blocks(tree, specs, mesh):
    """The blocks of ``tree``'s tensors one rank holds under ``specs``
    (a spec tree an argument when ``tree`` is a tuple of arguments), as
    new meta tensors of ``local_shape``: a rank's arguments for the dry
    run, with no storage."""
    return _over_args(lambda x, spec: torch.empty(
        local_shape(tuple(x.shape), spec, mesh), dtype=x.dtype,
        device="meta"), tree, specs)


def rank_blocks(tree, specs, mesh: LiveMesh):
    """This rank's blocks of the global ``tree`` under ``specs`` (as
    ``local_blocks``), each a contiguous tensor of its own on the mesh's
    device: what a rank of a sharded deployment holds."""
    return _over_args(lambda x, spec: NamedSharding(mesh, spec).place(x),
                      tree, specs)


def unblock(x, spec, mesh: LiveMesh):
    """The global tensor of this rank's block ``x`` under ``spec`` (the
    inverse of ``block``): gathered along each dimension over the axes
    its spec entry names; every rank gets it. A map's exit."""
    return _exit(x, spec, require_live(mesh, "unblock"))


def reblock(x, src, dst, mesh: LiveMesh):
    """This rank's block ``x`` under the spec ``src`` as its block under
    ``dst``. An axis that moves from one dimension to another (replicated
    there in ``src``, here in ``dst``) goes in one all-to-all; then every
    dimension whose entry changes is all-gathered over its ``src`` axes,
    and last each is cut to its ``dst`` block (the gathers first, so each
    gathers blocks that agree in every other dimension)."""
    n = max(len(src), len(dst))
    src = list(src) + [None] * (n - len(src))
    dst = tuple(dst) + (None,) * (n - len(dst))
    for i in range(n):
        a = src[i]
        if a is not None and a != dst[i] and a in dst:
            j = dst.index(a)
            if src[j] is None:
                x = all_to_all(x, a, mesh, split_axis=j, concat_axis=i)
                src[i], src[j] = None, a
    for i in range(n):
        if src[i] is not None and src[i] != dst[i]:
            x = all_gather(x, src[i], mesh, axis=i, tiled=True)
    for i in range(n):
        if dst[i] is not None and src[i] != dst[i]:
            step = x.shape[i] // mesh.axis_size(dst[i])
            x = x.narrow(i, mesh.axis_index(dst[i]) * step, step)
    return x


def _exit(x, spec, mesh):
    """A body's output as a global value: gathered along each dimension
    over the axes its spec entry names."""
    for dim, axes in enumerate(spec):
        if axes is not None and mesh.axis_size(axes) > 1:
            x = _Gather.apply(x, axes, mesh, dim, True, False)
    return x


def _enter(args, mesh):
    """The global inputs of a map, each tensor that records a gradient
    passed through ``_Enter`` once (a tensor given twice is one input)."""
    if not torch.is_grad_enabled():
        return args
    live = {}
    for x in tree_leaves(args):
        if torch.is_tensor(x) and x.requires_grad:
            live.setdefault(id(x), x)
    if not live:
        return args
    entered = dict(zip(live, _Enter.apply(mesh, *live.values())))
    return tree_map(lambda x: entered.get(id(x), x), args)


def constrain(x, logical: Sequence[Optional[str]], mesh: Optional[Mesh] = None,
              rules: Optional[dict] = None):
    """This rank's block of the global tensor ``x`` by logical names (the
    spec ``logical_to_physical`` gives for its shape)."""
    mesh = require_live(mesh, "constrain")
    x = torch.as_tensor(x)
    return block(x, logical_to_physical(logical, mesh, rules,
                                        shape=tuple(x.shape)), mesh)


def shard_map(f, mesh: Mesh, in_specs, out_specs, check_vma: bool = True):
    """A per-rank program over a live mesh (``jax.shard_map``): every
    rank calls ``run(*args)`` with the same global ``args``; ``f`` runs on
    this rank's blocks of them (``in_specs``: one spec tree an
    argument), and its outputs come back as global values, gathered over
    the axes their ``out_specs`` name (under ``()`` the value this rank
    holds; a tuple of outputs takes a tuple of spec trees, one an
    output, since a plain tuple of specs can read as one spec).
    Gradients flow back to the global inputs as the module docstring
    says. ``check_vma`` is the reference's flag, kept for its callers."""
    mesh = require_live(mesh, "shard_map")
    del check_vma

    def enter(x, spec):
        return block(x, spec, mesh)

    def leave(x, spec):
        return _exit(x, spec, mesh)

    def run(*args):
        args = _enter(args, mesh)
        out = f(*(_per_spec(enter, s, a)
                  for s, a in zip(in_specs, args, strict=True)))
        if type(out) is tuple:      # one spec tree an output
            return tuple(_per_spec(leave, s, o)
                         for s, o in zip(out_specs, out, strict=True))
        return _per_spec(leave, out_specs, out)

    run.body, run.in_specs, run.out_specs = f, in_specs, out_specs
    return run


# -- axis collectives (jax.lax.psum / pmean / all_gather / axis_index) -------

def axis_index(axis, mesh: LiveMesh) -> int:
    """This rank's index along ``axis`` (a name or a tuple of names)."""
    return require_live(mesh, "axis_index").axis_index(axis)


def _all_reduce(x: torch.Tensor, group, mesh: LiveMesh) -> torch.Tensor:
    """Sum the contiguous ``x`` over ``group`` in place; over gloo a
    half-precision tensor is summed in f32 and rounded once."""
    if mesh.backend == "gloo" and x.dtype in (torch.float16, torch.bfloat16):
        wide = x.float()
        dist.all_reduce(wide, dist.ReduceOp.SUM, group=group)
        return x.copy_(wide)
    dist.all_reduce(x, dist.ReduceOp.SUM, group=group)
    return x


class _Psum(torch.autograd.Function):
    """psum's all-reduce. Backward: the cotangent, the same on every
    rank, goes to this rank's partial unchanged."""

    @staticmethod
    def forward(ctx, x, group, mesh):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _gather_dim0(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's contiguous ``x`` stacked on a new leading dimension
    of ``n`` (one all-gather)."""
    out = x.new_empty(n * x.numel())
    _all_gather_into(out, x.reshape(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def _scatter_dim0(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """This rank's slot of the sum over ``group`` of the contiguous ``x``,
    whose leading dimension holds the ``n`` slots (one reduce-scatter)."""
    out = x.new_empty(x.numel() // n)
    _reduce_scatter_into(out, x.reshape(-1), group=group)
    return out.view(tuple(x.shape[1:]))


def _gathered(x, axes, mesh, dim, tiled):
    """``x`` from every rank along ``axes``, in ``axis_index`` order of
    the axes as given: stacked on a new dimension ``dim``, or
    concatenated along it when ``tiled``."""
    n = mesh.axis_size(axes)
    out = _gather_dim0(x.contiguous(), mesh.group(axes), n)
    order = mesh.slot_order(axes)
    if order is not None:                   # group rank -> axis index
        out = out[torch.tensor(order, device=out.device).argsort()]
    out = out.movedim(0, dim)
    if tiled:
        out = out.flatten(dim, dim + 1)
    return out


def _scattered(g, axes, mesh, dim, tiled):
    """This rank's slot along ``dim`` of the sum of ``g`` over ``axes``
    (the adjoint of ``_gathered``)."""
    n = mesh.axis_size(axes)
    if tiled:
        g = g.unflatten(dim, (n, g.shape[dim] // n))
    g = g.movedim(dim, 0)
    order = mesh.slot_order(axes)
    if order is not None:                   # each member's slot, by group rank
        g = g[torch.tensor(order, device=g.device)]
    return _scatter_dim0(g.contiguous(), mesh.group(axes), n)


class _Gather(torch.autograd.Function):
    """Every rank's x along ``axes`` in one all-gather: stacked on a new
    dimension ``dim``, or concatenated along it when ``tiled``. Backward:
    this rank's slot of the cotangent, summed over the axis first when
    ``reduce`` (one reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axes, mesh, dim, tiled, reduce):
        ctx.args = (axes, mesh, dim, tiled, reduce)
        return _gathered(x, axes, mesh, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, dim, tiled, reduce = ctx.args
        if reduce:
            return (_scattered(g, axes, mesh, dim, tiled), None, None, None,
                    None, None)
        i = mesh.axis_index(axes)
        if tiled:
            step = g.shape[dim] // mesh.axis_size(axes)
            g = g.narrow(dim, i * step, step)
        else:
            g = g.select(dim, i)
        return g, None, None, None, None, None


class _Scatter(torch.autograd.Function):
    """The sum of x over ``axes``, this rank's slot along ``dim`` (a
    block of it when ``tiled``, an index of it when not), in one
    reduce-scatter. Backward: the all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, axes, mesh, dim, tiled):
        ctx.args = (axes, mesh, dim, tiled)
        return _scattered(x, axes, mesh, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, dim, tiled = ctx.args
        return _gathered(g, axes, mesh, dim, tiled), None, None, None, None


class _Enter(torch.autograd.Function):
    """The identity on a map's global inputs. Backward: each gradient
    (zero outside this rank's block; a partial over the axes the input
    is replicated on) summed over every rank of the mesh, in one
    all-reduce a dtype."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        group = mesh.group(mesh.axis_names)
        out = list(gs)
        by_dtype: Dict[torch.dtype, list] = {}
        for j, g in enumerate(gs):
            by_dtype.setdefault(g.dtype, []).append(j)
        for idx in by_dtype.values():
            flat = _all_reduce(torch.cat([gs[j].reshape(-1) for j in idx]),
                               group, mesh)
            parts = torch.split(flat, [gs[j].numel() for j in idx])
            for j, part in zip(idx, parts):
                out[j] = part.view(gs[j].shape)
        return (None, *out)


def _flat(tree):
    leaves = tree_leaves(tree)
    flat = torch.cat([torch.as_tensor(x).reshape(-1) for x in leaves]) \
        if len(leaves) > 1 else torch.as_tensor(leaves[0]).reshape(-1)
    return leaves, flat


def _unflat(tree, leaves, flat):
    parts = iter(torch.split(flat, [torch.as_tensor(x).numel()
                                    for x in leaves]))
    return tree_map(lambda x: next(parts).reshape(torch.as_tensor(x).shape),
                    tree)


def psum(tree, axis, mesh: LiveMesh):
    """The sum over the ranks along ``axis`` of every leaf of ``tree``
    (one all-reduce for the whole tree; leaves of one dtype). Backward:
    as the module docstring says."""
    group = require_live(mesh, "psum").group(axis)
    if group is None:
        return tree
    leaves, flat = _flat(tree)
    return _unflat(tree, leaves, _Psum.apply(flat, group, mesh))


def pmean(tree, axis, mesh: LiveMesh):
    """The mean over the ranks along ``axis``: ``psum`` over their count."""
    n = require_live(mesh, "pmean").axis_size(axis)
    return tree_map(lambda x: x / n, psum(tree, axis, mesh))


def pmax(x: torch.Tensor, axis, mesh: LiveMesh) -> torch.Tensor:
    """The elementwise maximum over the ranks along ``axis`` (one
    all-reduce), detached: a stabilizer that no gradient flows
    through."""
    group = require_live(mesh, "pmax").group(axis)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(out, dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, axis_name, mesh: LiveMesh, *,
               axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along the mesh axes ``axis_name``, in
    axis-index order (``jax.lax.all_gather``): stacked on a new
    dimension at ``axis``, or concatenated along ``axis`` when
    ``tiled``. One all-gather, exact; its backward is a reduce-scatter
    (``_Gather``)."""
    mesh = require_live(mesh, "all_gather")
    if mesh.group(axis_name) is None:
        return x if tiled else x.unsqueeze(axis)
    return _Gather.apply(x, axis_name, mesh, axis, tiled, True)


def psum_scatter(x: torch.Tensor, axis_name, mesh: LiveMesh, *,
                 scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis_name``, this rank's
    slot of it along ``scatter_dimension`` (``jax.lax.psum_scatter``):
    the dimension's ``axis_index``-th entry (it must equal the rank
    count), or its block when ``tiled``. One reduce-scatter; its
    backward is an all-gather."""
    mesh = require_live(mesh, "psum_scatter")
    if mesh.group(axis_name) is None:
        return x if tiled else x.squeeze(scatter_dimension)
    n = mesh.axis_size(axis_name)
    size = x.shape[scatter_dimension]
    if (size % n) if tiled else (size != n):
        raise ValueError(f"dimension {scatter_dimension} of "
                         f"{tuple(x.shape)} does not scatter over {n} ranks")
    return _Scatter.apply(x, axis_name, mesh, scatter_dimension, tiled)


def _exchanged(x, axes, mesh, split, concat):
    """``x`` cut into the ranks' pieces along ``split``, piece i sent to
    axis index i, and the pieces received concatenated along ``concat``
    in axis-index order (one all-to-all)."""
    n = mesh.axis_size(axes)
    order = mesh.slot_order(axes)
    parts = x.unflatten(split, (n, x.shape[split] // n)).movedim(split, 0)
    if order is not None:               # group rank r takes order[r]'s piece
        parts = parts[torch.tensor(order, device=x.device)]
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=mesh.group(axes))
    if order is not None:               # group rank -> axis index
        out = out[torch.tensor(order, device=x.device).argsort()]
    return out.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    """``_exchanged``. Backward: the exchange back, its cut and
    concatenated dimensions swapped."""

    @staticmethod
    def forward(ctx, x, axes, mesh, split, concat):
        ctx.args = (axes, mesh, split, concat)
        return _exchanged(x, axes, mesh, split, concat)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, split, concat = ctx.args
        return _exchanged(g, axes, mesh, concat, split), None, None, None, \
            None


def all_to_all(x: torch.Tensor, axis_name, mesh: LiveMesh, *,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``: ``split_axis`` cut into one block a rank along
    ``axis_name``, each rank's blocks for this rank concatenated along
    ``concat_axis``. One all-to-all; its backward is the exchange
    back."""
    mesh = require_live(mesh, "all_to_all")
    if mesh.group(axis_name) is None:
        return x
    n = mesh.axis_size(axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    return _AllToAll.apply(x, axis_name, mesh, split_axis, concat_axis)


class _Pvary(torch.autograd.Function):
    """The identity. Backward: the cotangent summed over the ranks."""

    @staticmethod
    def forward(ctx, x, group, mesh):
        ctx.args = (group, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, mesh = ctx.args
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           group, mesh), None, None


def pvary(x: torch.Tensor, axis, mesh: LiveMesh) -> torch.Tensor:
    """``x``, the same on every rank along ``axis``, as a value each rank
    goes on to use in its own way (``jax.lax.pvary``): the identity,
    whose backward sums the ranks' cotangents (one all-reduce). After a
    ``psum`` whose sum each rank reads for its own shard (a norm over
    sharded features), so that every rank's partial gets the whole
    cotangent."""
    group = require_live(mesh, "pvary").group(axis)
    if group is None or not torch.is_grad_enabled():
        return x
    return _Pvary.apply(x, group, mesh)
