"""Loss registry — DML objectives and LM loss as first-class, composable
losses (counterpart of ``repro/core/losses.py``).

Every loss has signature ``loss_fn(params, batch) -> (scalar, aux_dict)``
so the PS trainer and the benchmarks can swap them freely.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import dml
from repro_torch.kernels._dispatch import full_f32
from repro_torch.kernels.dml_pair import dml_pair_loss_and_d2
from repro_torch.kernels.dml_pair.ops import dml_pair_forward
from repro_torch.sharding import partition

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
_REGISTRY: Dict[str, LossFn] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> LossFn:
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


@register("dml_pair")
def dml_pair_loss(L, batch, *, lam: float = 1.0, margin: float = 1.0,
                  compute_dtype=None):
    """Paper Eq. 4 over a pair minibatch {xs, ys, sim}.

    In f32 (``compute_dtype`` None or float32) the loss is the fused
    ``dml_pair`` forward with its closed-form backward: the kernel on CUDA
    tensors, its plain version on CPU tensors; the aux statistics come
    from its d2. Another ``compute_dtype`` (e.g. bf16) casts the products
    as the reference does, on either device: the reference computes that
    case with a plain cast-and-product outside its Pallas kernel.
    """
    xs, ys, sim = batch["xs"], batch["ys"], batch["sim"]
    if compute_dtype not in (None, torch.float32):
        loss = dml.objective(L, xs, ys, sim, lam=lam, margin=margin,
                             compute_dtype=compute_dtype)
        d2 = dml.mahalanobis_sqdist(L.detach(), xs, ys)
    else:
        loss, d2 = dml_pair_loss_and_d2(L, xs, ys, sim, lam, margin)
    simf = sim.to(torch.float32)
    aux = {
        "loss": loss.detach(),
        "mean_sim_dist": torch.sum(d2 * simf)
        / torch.clamp_min(torch.sum(simf), 1.0),
        "mean_dis_dist": torch.sum(d2 * (1 - simf))
        / torch.clamp_min(torch.sum(1 - simf), 1.0),
        "hinge_active_frac": torch.mean((d2 < margin) * (1 - simf)),
    }
    return loss, aux


def dml_pair_value_and_grad_rank(L, batch, mesh, *, rows_split: bool,
                                 lam: float = 1.0, margin: float = 1.0):
    """One rank's Eq. 4 value and gradient on a live ``mesh``: ``batch``
    this rank's pairs (sharded over the batch axes ``pod`` / ``data``),
    ``L`` its rows (over ``model`` when ``rows_split``, else all of
    them). The ``dml_pair`` forward (the kernel on CUDA tensors) gives
    the rank's d2 and projection; with the rows split its d2 is a partial,
    summed over ``model`` before the hinge (the kernel's own loss, taken
    on the partial, is not used). The closed-form gradient of the rank's
    rows (``kernels/dml_pair/ops.py``'s backward) and the mean loss are
    summed over the batch axes. Returns (loss, dL), the loss the same on
    every rank."""
    full_f32()
    xs, ys, sim = batch["xs"], batch["ys"], batch["sim"]
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_pairs = xs.shape[0] * (mesh.axis_size(axes) if axes else 1)
    _, d2, proj = dml_pair_forward(L, xs, ys, sim, lam, margin)
    if rows_split:
        d2 = partition.psum(d2, "model", mesh)
    simf = sim.to(torch.float32)
    losses = simf * d2 + (1.0 - simf) * lam * torch.clamp_min(margin - d2,
                                                              0.0)
    w = simf - lam * (1.0 - simf) * (d2 < margin).to(torch.float32)
    z = (xs - ys).to(torch.float32)
    dL = ((2.0 / n_pairs) * (proj * w[:, None]).T) @ z
    loss, dL = partition.psum((torch.sum(losses)[None] / n_pairs, dL),
                              axes, mesh)
    return loss[0], dL.to(L.dtype)


@register("dml_triplet")
def dml_triplet_loss(L, batch, *, margin: float = 1.0, compute_dtype=None):
    """Triple-wise constraint extension (paper §4)."""
    loss = dml.triplet_objective(L, batch["anchor"], batch["pos"],
                                 batch["neg"], margin=margin,
                                 compute_dtype=compute_dtype)
    return loss, {"loss": loss.detach()}


def softmax_cross_entropy(logits, labels, mask=None):
    """Token-level mean CE. logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


@register("lm")
def lm_loss(logits, batch):
    """Next-token LM loss given precomputed logits and {labels, mask?}."""
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss.detach()}
