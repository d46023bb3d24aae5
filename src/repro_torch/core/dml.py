"""Metric-factor configuration and initialisation (Xie & Xing 2014).

Counterpart of ``DMLConfig`` and ``init_params`` in ``repro/core/dml.py``;
the Eq. 4 objective and its gradients belong to the training slice.
``M = L^T L`` with ``L`` of shape ``(d_out, d_in)``, ``d_out <= d_in``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DMLConfig:
    """Hyper-parameters of the reformulated DML objective (paper §3/§5.2).

    ``proj_dim`` and ``l_rank`` are two names for ``d_out``, the rows of
    the learned (d_out, d_in) factor. Setting neither gives a square
    factor; setting both to different values is an error.
    """

    feat_dim: int                     # d_in — feature dimensionality
    proj_dim: Optional[int] = None    # d_out — rows of L (<= d_in)
    lam: float = 1.0        # lambda — dissimilar-pair tradeoff (paper: 1)
    margin: float = 1.0     # c — dissimilarity margin (paper: 1)
    dtype: torch.dtype = torch.float32
    # low-rank knob: alias for proj_dim (d_out of the rectangular factor)
    l_rank: Optional[int] = None

    def __post_init__(self):
        if (self.proj_dim is not None and self.l_rank is not None
                and self.proj_dim != self.l_rank):
            raise ValueError(
                f"proj_dim={self.proj_dim} and l_rank={self.l_rank} "
                f"disagree; they name the same d_out — set one")
        d_out = self.proj_dim if self.proj_dim is not None else self.l_rank
        if d_out is None:
            d_out = self.feat_dim           # square factor by default
        object.__setattr__(self, "proj_dim", int(d_out))
        if not 1 <= self.proj_dim <= self.feat_dim:
            raise ValueError(
                f"proj_dim d_out={self.proj_dim} must be in "
                f"1..feat_dim d_in={self.feat_dim}")


def init_params(cfg: DMLConfig, generator: torch.Generator,
                device) -> torch.Tensor:
    """Initialize L (d_out, d_in) on ``device`` from ``generator`` (which
    must live on that device). Scaled Gaussian so initial distances are
    O(1)."""
    scale = 1.0 / np.sqrt(cfg.feat_dim)
    return scale * torch.randn((cfg.proj_dim, cfg.feat_dim),
                               generator=generator, dtype=cfg.dtype,
                               device=device)
