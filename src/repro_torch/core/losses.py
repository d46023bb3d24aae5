"""Loss registry — DML objectives and LM loss as first-class, composable
losses (counterpart of ``repro/core/losses.py``).

Every loss has signature ``loss_fn(params, batch) -> (scalar, aux_dict)``
so the PS trainer and the benchmarks can swap them freely.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import dml
from repro_torch.kernels.dml_pair import dml_pair_loss_and_d2

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
