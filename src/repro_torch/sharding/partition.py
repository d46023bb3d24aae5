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
one rank's shard.

Over a live mesh (``launch/mesh.LiveMesh``, one process a rank) a global
tensor is the same on every rank and a sharded one is held as this
rank's block: ``block`` / ``constrain`` take this rank's block of a
global tensor, ``shard_map`` runs a function on this rank's blocks, and
the axis collectives ``psum``, ``pmean``, ``all_gather`` and
``axis_index`` are the counterparts of ``jax.lax``'s inside a
``shard_map`` body. On a named shape (``Mesh``) there is no group, and
``constrain`` / ``shard_map`` raise.
"""

from __future__ import annotations

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

_MULTI_GPU = ("needs a process group: multi-GPU is ROADMAP.md Queue 1 "
              "item 8")


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


def _blocks(spec, tree, mesh):
    """``block`` over a tree of tensors: ``spec`` mirrors the tree's
    dicts, NamedTuples and lists (a list for a plain tuple too), and a
    spec (a plain tuple; None for ``()``) covers the subtree under it."""
    if tree is None:
        return None
    if spec is None or _is_spec(spec):
        return tree_map(lambda x: block(x, spec or (), mesh), tree)
    if isinstance(tree, dict):
        return {k: _blocks(spec[k], v, mesh) for k, v in tree.items()}
    out = [_blocks(s, t, mesh) for s, t in zip(spec, tree, strict=True)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def constrain(x, logical: Sequence[Optional[str]], mesh: Optional[Mesh] = None,
              rules: Optional[dict] = None):
    """This rank's block of the global tensor ``x`` by logical names (the
    spec ``logical_to_physical`` gives for its shape)."""
    mesh = require_live(mesh, "constrain")
    x = torch.as_tensor(x)
    return block(x, logical_to_physical(logical, mesh, rules,
                                        shape=tuple(x.shape)), mesh)


def shard_map(f, mesh: Mesh, in_specs, out_specs, check_vma: bool = True):
    """A per-rank program over a live mesh: ``run(*args)`` calls ``f`` on
    this rank's blocks of the global ``args`` (``in_specs``: one spec
    tree an argument). Every rank calls ``run``; ``f``'s outputs come
    back as they are: this rank's block under an out spec that names an
    axis, the value every rank holds under ``()``. ``check_vma`` is the
    reference's flag, kept for its callers."""
    mesh = require_live(mesh, "shard_map")
    del out_specs, check_vma

    def run(*args):
        return f(*(_blocks(s, a, mesh)
                   for s, a in zip(in_specs, args, strict=True)))

    return run


# -- axis collectives (jax.lax.psum / pmean / all_gather / axis_index) -------

def axis_index(axis, mesh: LiveMesh) -> int:
    """This rank's index along ``axis`` (a name or a tuple of names)."""
    return require_live(mesh, "axis_index").axis_index(axis)


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
    (one all-reduce for the whole tree; leaves of one dtype)."""
    group = require_live(mesh, "psum").group(axis)
    if group is None:
        return tree
    leaves, flat = _flat(tree)
    flat = flat.clone()
    dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
    return _unflat(tree, leaves, flat)


def pmean(tree, axis, mesh: LiveMesh):
    """The mean over the ranks along ``axis``: ``psum`` over their count."""
    n = require_live(mesh, "pmean").axis_size(axis)
    return tree_map(lambda x: x / n, psum(tree, axis, mesh))


def all_gather(x: torch.Tensor, axis, mesh: LiveMesh) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked on a new leading
    dimension in axis-index order (``jax.lax.all_gather``).

    Built as an all-reduce of a zero buffer in which each rank writes its
    own slot, since gloo takes CUDA tensors for all-reduce: exact, as x +
    0 is x (the BIG sentinels too) and integers add exactly."""
    mesh = require_live(mesh, "all_gather")
    group = mesh.group(axis)
    if group is None:
        return x[None]
    buf = x.new_zeros((mesh.axis_size(axis),) + tuple(x.shape))
    buf[mesh.axis_index(axis)] = x
    dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)
    return buf
