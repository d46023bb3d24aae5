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
one rank's shard. Placing tensors by a plan (``constrain``,
``shard_map``) needs a process group and comes with the multi-GPU slice
(ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import Mesh

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


def constrain(x, logical: Sequence[Optional[str]], mesh: Optional[Mesh] = None,
              rules: Optional[dict] = None):
    """Placement by logical names: not on one process."""
    raise NotImplementedError(f"constrain {_MULTI_GPU}")


def shard_map(f, mesh: Mesh, in_specs, out_specs, check_vma: bool = True):
    """A per-rank program over a mesh: not on one process."""
    raise NotImplementedError(f"shard_map {_MULTI_GPU}")
