"""Plain reference of the training cells: Eq. 4 under bsp SGD.

Paper Eq. 4 over a minibatch of pairs (mean form):

    f(L) = 1/B sum_b  s_b ||L z_b||^2 + (1 - s_b) lam max(0, c - ||L z_b||^2)

with z_b = x_b - y_b. Its gradient is
``2/B sum_b w_b (L z_b) z_b^T``, w_b = s_b - lam (1 - s_b) [||L z_b||^2 < c].
Under bsp each of the P workers takes the gradient of its own batch,
the server averages the P gradients, and every copy takes the same SGD
step with lr_t = lr0 / (1 + decay t), t = 1, 2, ...

Which pairs a worker's step takes is worked out again here from the pair
arrays and the stream's seed: a frozen copy of the pair source's
partition (paper §4.1: the pairs split into P contiguous shards) and its
batch draws (half similar, half dissimilar, distinct within a batch,
from ``numpy.random.RandomState(seed + p)``).

Imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference.precision import dtype, matmul


def _distinct_draws(rng, n_pool: int, size: int) -> np.ndarray:
    if size > n_pool:
        return rng.randint(0, n_pool, size)
    if 4 * size >= n_pool:
        return rng.permutation(n_pool)[:size]
    out = np.unique(rng.randint(0, n_pool, size))
    while len(out) < size:
        out = np.union1d(out, rng.randint(0, n_pool, 2 * (size - len(out))))
    return out[rng.permutation(len(out))[:size]]


def worker_batches(pairs: dict, n_workers: int, batch_size: int, seed: int,
                   steps: int):
    """[step][worker] -> the global pair rows of that worker's batch."""
    n = pairs["sim"].shape[0]
    out = [[None] * n_workers for _ in range(steps)]
    for p, shard in enumerate(np.array_split(np.arange(n), n_workers)):
        sim = pairs["sim"][shard]
        rng = np.random.RandomState(seed + p)
        sim_idx = np.nonzero(sim == 1)[0]
        dis_idx = np.nonzero(sim == 0)[0]
        h = batch_size // 2
        for t in range(steps):
            if len(sim_idx) and len(dis_idx):
                sel = np.concatenate([
                    sim_idx[_distinct_draws(rng, len(sim_idx), h)],
                    dis_idx[_distinct_draws(rng, len(dis_idx),
                                            batch_size - h)]])
            else:
                sel = _distinct_draws(rng, len(sim), batch_size)
            out[t][p] = shard[sel]
    return out


def eq4(L, xs, ys, sim, lam: float, margin: float, precision: str):
    """(mean loss, gradient) of Eq. 4 in ``precision``."""
    dt = dtype(precision)
    z = xs.to(dt) - ys.to(dt)
    proj = matmul(z, L.T, precision)                    # (B, d_out)
    d2 = torch.sum(proj * proj, dim=1)
    s = sim.to(dt)
    loss = torch.mean(s * d2 + (1 - s) * lam * torch.clamp_min(margin - d2,
                                                              0.0))
    w = s - lam * (1 - s) * (d2 < margin).to(dt)
    grad = matmul(((2.0 / xs.shape[0]) * proj * w[:, None]).T, z, precision)
    return loss, grad


def lr_at(lr0: float, decay: float, t: int) -> float:
    """The schedule's rate at optimizer step t (1-based), as float32."""
    return float(np.float32(lr0) / (np.float32(1.0) + np.float32(decay)
                                    * np.float32(t)))


def bsp_sgd(features, pairs: dict, L0, n_workers: int, batch_size: int,
            seed: int, lr0: float, decay: float, steps: int, lam: float,
            margin: float, precision: str = "f64"):
    """``steps`` bsp SGD steps of P workers from ``L0`` over the rows of
    ``features`` (a device tensor) that the pair arrays index. Returns
    {losses: [mean over workers a step], grad1: the first step's averaged
    gradient, params: [L after each step]} in ``precision``'s dtype."""
    dt = dtype(precision)
    L = L0.to(dt)
    dev = features.device
    plan = worker_batches(pairs, n_workers, batch_size, seed, steps)
    losses, params, grad1 = [], [], None
    for t in range(steps):
        ls, gs = [], []
        for p in range(n_workers):
            rows = plan[t][p]
            a = torch.from_numpy(pairs["a"][rows]).to(dev)
            b = torch.from_numpy(pairs["b"][rows]).to(dev)
            s = torch.from_numpy(pairs["sim"][rows]).to(dev)
            loss, g = eq4(L, features[a], features[b], s, lam, margin,
                          precision)
            ls.append(loss)
            gs.append(g)
        gbar = torch.mean(torch.stack(gs), dim=0)
        if t == 0:
            grad1 = gbar
        L = L - lr_at(lr0, decay, t + 1) * gbar
        losses.append(float(torch.mean(torch.stack(ls))))
        params.append(L)
    return {"losses": losses, "grad1": grad1, "params": params}
