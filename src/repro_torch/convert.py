"""Carry the JAX package's weights, index arrays and training state
across to the port.

Every function takes plain numpy arrays (``np.asarray`` of the
reference's ``jax.Array``s, e.g. ``jax.tree.map(np.asarray, state)``),
so this module imports nothing of JAX. Optimizer and PS states are
matched by their NamedTuple's class name and fields.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ps.sync import PSState
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import check_metric_factor
from repro_torch.optim import AdamState, MomentumState, ScaleState
from repro_torch.serve.index import ExactIndex
from repro_torch.tree import tree_map

_OPT_STATES = {cls.__name__: cls for cls in
               (ScaleState, MomentumState, AdamState)}


def _tensor(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


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


def opt_state_from_jax(state, device=None):
    """A reference optimizer state (``ScaleState`` / ``MomentumState`` /
    ``AdamState`` with numpy leaves, worker-stacked or not) as the port's
    state of the same name, leaves bit for bit on ``device``."""
    dev = resolve_device(device)
    cls = _OPT_STATES.get(type(state).__name__)
    if cls is None or tuple(getattr(state, "_fields", ())) != cls._fields:
        raise ValueError(f"not a ScaleState / MomentumState / AdamState: "
                         f"{type(state).__name__}")
    return cls(*(tree_map(lambda x: _tensor(x, dev), field)
                 for field in state))


def ps_state_from_jax(state, device=None) -> PSState:
    """A reference ``PSState`` (numpy leaves) as the port's: the
    worker-stacked params and optimizer states, the step and the SSP
    ring, bit for bit. The reference's PRNG key is dropped: the port
    takes the SSP delays as an input (``sync.make_train_step``)."""
    dev = resolve_device(device)
    ring = state.grad_ring
    return PSState(
        params=_tensor(state.params, dev),
        opt_state=opt_state_from_jax(state.opt_state, dev),
        step=int(np.asarray(state.step)),
        grad_ring=None if ring is None else _tensor(ring, dev))
