"""Tree checkpointing (npz payload + msgpack manifest), counterpart of
``repro/checkpoint/ckpt.py`` and in its on-disk format.

``<ckpt_dir>/step_%08d.npz`` holds one array a leaf under its path
("params/blocks/0/mamba/w_z": dict keys sorted, list items and NamedTuple
fields in order, as ``jax.tree_util`` flattens them; ``None`` holds no
leaf), and ``step_%08d.manifest.msgpack`` the step, the array keys and
the Python-scalar leaves. The manifest's MessagePack is written and read
by ``_msgpack`` (the card's machine has no ``msgpack`` package). A tree
in the reference's layout (``models.transformer.stack_blocks``) gives
the reference's files bit for bit, and a reference checkpoint restores
into such a tree. ``keep`` keeps the newest checkpoints and deletes the
older ones. Tensors are copied to the host to be written; a restore
places each array on its target leaf's device in the target's dtype, or,
where ``shardings`` gives the leaf a ``sharding.partition.NamedSharding``
on a live mesh, as this rank's block on the mesh's device (the
reference places such a leaf with ``jax.device_put``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

_SCALARS = (bool, int, float, str)


def _flatten_with_paths(tree, prefix=()):
    """[(path, leaf)] in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _flatten_with_paths(v, prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves, prefix=()):
    """``tree``'s structure with the leaf at each path from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves, prefix + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3):
    """Write tree to <ckpt_dir>/step_<step>.npz + .manifest.msgpack."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "keys": [], "scalars": {}}
    for k, v in _flatten_with_paths(tree):
        if isinstance(v, _SCALARS):
            manifest["scalars"][k] = v
            continue
        arrays[k] = _host(v)
        manifest["keys"].append(k)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    np.savez(path + ".npz", **arrays)
    with open(path + ".manifest.msgpack", "wb") as f:
        f.write(_msgpack.packb(manifest))
    _gc(ckpt_dir, keep)
    return path + ".npz"


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        for suffix in (".npz", ".manifest.msgpack"):
            p = os.path.join(ckpt_dir, f"step_{s:08d}{suffix}")
            if os.path.exists(p):
                os.remove(p)


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for fn in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)\.npz$", fn)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: Any,
                       step: Optional[int] = None, shardings: Any = None):
    """Restore into the structure of ``target``; returns (tree, step).
    A tensor leaf comes back as a tensor in the target's dtype on the
    target's device, a numpy leaf as numpy in its dtype, a scalar leaf
    from the manifest. ``shardings`` (optional) is a tree matching
    ``target`` of ``NamedSharding`` (or None) leaves: a leaf with one
    comes back as this rank's block of it, a tensor on the mesh's
    device (``NamedSharding.place``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(path + ".npz")
    with open(path + ".manifest.msgpack", "rb") as f:
        manifest = _msgpack.unpackb(f.read())

    restored = {}
    for k, v in _flatten_with_paths(target):
        if k in manifest["scalars"]:
            restored[k] = manifest["scalars"][k]
        elif k in data:
            arr = data[k]
            if torch.is_tensor(v):
                restored[k] = torch.from_numpy(np.array(arr)).to(
                    dtype=v.dtype, device=v.device)
            else:
                restored[k] = arr.astype(v.dtype) if hasattr(v, "dtype") \
                    else arr
        else:
            raise KeyError(f"checkpoint {path} missing leaf {k}")
    if shardings is not None:
        for k, sharding in _flatten_with_paths(shardings):
            if k not in restored:
                raise KeyError(f"a sharding for {k}, which the target "
                               f"does not have")
            if not isinstance(restored[k], _SCALARS):
                restored[k] = sharding.place(restored[k])
    return _unflatten(target, restored), step
