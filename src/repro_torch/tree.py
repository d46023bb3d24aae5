"""Parameter trees: the port's counterpart of ``jax.tree`` and
``jax.value_and_grad`` for the few structures the trainer uses.

A tree is a tensor (a leaf), ``None``, or a dict / list / tuple /
NamedTuple of trees. Optimizer states are NamedTuples of tensors and
trees; the DML parameters are one tensor.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of the same structure; ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in a fixed order (dict keys as stored)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def value_and_grad(fn: Callable, params, *args):
    """``((value, aux), grads)`` of ``fn(params, *args) -> (scalar, aux)``
    with respect to every leaf of ``params`` (``jax.value_and_grad`` with
    ``has_aux=True``). The value, aux and grads come back detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    with torch.enable_grad():
        value, aux = fn(tree_map(lambda _: next(it), params), *args)
        grads = torch.autograd.grad(value, live)
    it = iter(grads)
    return ((value.detach(), tree_map(torch.Tensor.detach, aux)),
            tree_map(lambda _: next(it), params))
