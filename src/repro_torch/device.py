"""Device resolution for the port's entry points.

``device=None`` means the CUDA card. Without a card the entry points
raise instead of carrying on quietly on the CPU: the CPU is taken only
when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev
