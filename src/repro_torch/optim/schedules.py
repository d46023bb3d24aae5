"""Learning-rate schedules as step -> lr callables (counterpart of
``repro/optim/schedules.py``); ``step`` is an int tensor, the lr an f32
tensor on its device."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def inverse_time(lr0: float, decay: float = 1e-3):
    """lr0 / (1 + decay * step) — the classic asynchronous-SGD schedule."""
    return lambda step: lr0 / (1.0 + decay * step.to(torch.float32))


def cosine(lr0: float, total_steps: int, warmup: int = 0,
           floor: float = 0.0):
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp_max(s / max(warmup, 1), 1.0) if warmup else 1.0
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return lr0 * warm * cos
    return fn


def linear_warmup(lr0: float, warmup: int):
    def fn(step):
        s = step.to(torch.float32)
        return lr0 * torch.clamp_max(s / max(warmup, 1), 1.0)
    return fn
