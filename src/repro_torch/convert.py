"""Carry the JAX package's weights and index arrays across to the port.

Both take plain numpy arrays (``np.asarray`` of the reference's
``jax.Array``s), so this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import check_metric_factor
from repro_torch.serve.index import ExactIndex


def metric_factor_from_jax(L_np, device=None) -> torch.Tensor:
    """The reference's (d_out, d_in) factor as an f32 tensor on ``device``
    (the card by default)."""
    L = torch.from_numpy(np.array(L_np, dtype=np.float32, copy=True))
    return check_metric_factor(L).to(resolve_device(device))


def exact_index_from_jax(L_np, gp_np, gn_np, device=None) -> ExactIndex:
    """A port ExactIndex over the arrays of a reference ExactIndex
    (``L``, ``gp``, ``gn``): no re-projection, the same rows bit for bit."""
    dev = resolve_device(device)
    return ExactIndex.from_projected(
        metric_factor_from_jax(L_np, dev),
        torch.from_numpy(np.array(gp_np, dtype=np.float32, copy=True)),
        torch.from_numpy(np.array(gn_np, dtype=np.float32, copy=True)),
        device=dev)
