"""Hand-rolled functional optimizers (counterpart of
``repro/optim/optimizers.py``), with an optax-like interface:

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Params, grads and states are trees (``repro_torch.tree``); every
transform returns new tensors and leaves its inputs untouched. The
optimizer step count is a 0-d int32 tensor on the params' device, as in
the reference. The PS server-side optimizer (paper §4.2 "update thread")
is one of these applied to aggregated gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)


def _zero_step(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params=None)


class ScaleState(NamedTuple):
    step: torch.Tensor


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return ScaleState(step=_zero_step(params))

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        updates = tree_map(lambda g: -lr_t * g, grads)
        return updates, ScaleState(step=step)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    step: torch.Tensor
    mu: Any


def momentum(lr: Schedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(step=_zero_step(params),
                             mu=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: beta * m + g, state.mu, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr_t * (beta * m + g), mu, grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, mu)
        return upd, MomentumState(step=step, mu=mu)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=weight_decay)


def _adam_impl(lr, b1, b2, eps, weight_decay) -> Optimizer:
    def init(params):
        return AdamState(step=_zero_step(params),
                         m=tree_map(torch.zeros_like, params),
                         v=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state.v, grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def u(m_, v_, p):
            upd = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay and p is not None:
                upd = upd - lr_t * weight_decay * p
            return upd

        if weight_decay and params is not None:
            updates = tree_map(u, m, v, params)
        else:
            updates = tree_map(lambda m_, v_: u(m_, v_, None), m, v)
        return updates, AdamState(step=step, m=m, v=v)

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp_max(max_norm / (gn + 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), gn


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
