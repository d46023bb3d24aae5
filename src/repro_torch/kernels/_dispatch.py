"""Shared kernel-dispatch helpers: factor validation, padding, tiling.

Counterpart of ``repro/kernels/_dispatch.py``. Dispatch between a kernel
and its plain version goes by the tensor's device (CUDA -> kernel, CPU
-> plain), so there is no ``default_interpret`` here. The CUDA kernels
mask their ragged edges themselves; ``round_up`` / ``pad_axis`` /
``pick_block`` serve the plain paths and the wrappers' scratch sizing.
``topk_by_distance`` is the one tie-breaking contract every scan path
must agree on: ascending distance, equal distances smallest-id-first.
``full_f32`` is the one place the plain paths pin full-f32 products.
"""

from __future__ import annotations

import torch


def full_f32():
    """Switch TF32 off for float32 matrix products on the card.

    TF32 keeps about three decimal digits, and one call of
    ``torch.set_float32_matmul_precision("high")`` anywhere in the process
    turns it on for ``torch.matmul``. Parity with the kernels and with the
    JAX reference (whose f32 products on the CPU are full f32) needs true
    f32, so every plain path and every backward product calls this first.
    """
    torch.backends.cuda.matmul.allow_tf32 = False


def check_metric_factor(L, d_in=None, *, what: str = "L"):
    """Validate the ``(d_out, d_in)`` metric-factor contract up front.

    L is 2-D with raw features on the *second* axis; rectangular
    ``d_out < d_in`` is as legal as square. A transposed / 1-D /
    wrong-dim factor raises one clear ValueError (same messages as the
    reference). Returns L unchanged.
    """
    shape = tuple(L.shape)
    if len(shape) != 2:
        raise ValueError(
            f"{what} must be a 2-D (d_out, d_in) metric factor, got "
            f"shape {shape}")
    d_out, d = shape
    if d_out < 1 or d < 1:
        raise ValueError(
            f"{what} must have d_out >= 1 and d_in >= 1, got shape "
            f"{shape}")
    if d_in is not None and d != d_in:
        # rows matching the data dim is the transposed-factor signature
        hint = (" — transposed factor? the contract is rows = d_out, "
                "columns = d_in" if d_out == d_in else "")
        raise ValueError(
            f"{what} has d_in={d} but the data is {d_in}-dimensional; "
            f"expected {what}.shape == (d_out, {d_in}){hint}")
    return L


def round_up(n: int, mult: int) -> int:
    return n + (-n) % mult


def pad_axis(x: torch.Tensor, target: int, axis: int, value=0.0):
    """Pad ``x`` along ``axis`` up to length ``target`` with ``value``
    (no-op when already there)."""
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def pick_block(n: int, block: int, mult: int) -> int:
    """Row-tile size: the configured ``block`` when ``n`` fills it,
    else all of ``n`` rounded up to ``mult`` (a single tile)."""
    return block if n >= block else round_up(n, mult)


def topk_by_distance(d: torch.Tensor, ids: torch.Tensor, k_top: int):
    """Top-k candidates by distance with a deterministic presentation.

    Selects the ``k_top`` smallest distances with a stable sort (ties
    toward the earlier candidate *position*, as ``lax.top_k``), then
    re-sorts the survivors lexicographically by (distance, id) so
    equal-distance neighbors come back smallest-id-first.
    """
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k_top]
    cd = torch.gather(d, -1, order)
    ci = torch.gather(ids, -1, order)
    by_id = torch.sort(ci, dim=-1, stable=True).indices       # minor key
    cd, ci = torch.gather(cd, -1, by_id), torch.gather(ci, -1, by_id)
    by_d = torch.sort(cd, dim=-1, stable=True).indices        # major key
    return torch.gather(cd, -1, by_d), torch.gather(ci, -1, by_d)
