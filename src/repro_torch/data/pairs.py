"""Synthetic pair-constraint datasets mirroring the paper's setup (§5.1).

Counterpart of ``repro/data/pairs.py``: the same numpy ``RandomState``
draws in the same order, so both packages give byte-identical features,
labels, pair indices and batch rows.

  * ``class_blobs``    — Gaussian blobs around random class centers;
  * ``mnist_like``     — nonnegative, bounded, class-dependent masks;
  * ``noisy_subspace`` — class signal in a small subspace under noise;
  * ``llc_like``       — sparse nonnegative codes mimicking LLC features
                         (the ImageNet-63K / ImageNet-1M configs).

Pair sampling matches the paper: uniform over same-class pairs for S, over
different-class pairs for D. Features, labels and pair sets stay numpy;
the batch streams hand out torch tensors on a device (the card unless
``device="cpu"``). ``pair_batches_from_indices`` keeps the feature store
on that device and gathers each batch there by index.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PairDatasetConfig:
    n_samples: int
    feat_dim: int
    n_classes: int
    kind: str = "class_blobs"   # class_blobs|mnist_like|noisy_subspace|llc_like
    noise: float = 0.3
    sparsity: float = 0.9           # fraction of zero dims (llc_like)
    seed: int = 0


def make_features(cfg: PairDatasetConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features (n, d) float32, labels (n,) int32)."""
    rng = np.random.RandomState(cfg.seed)
    labels = rng.randint(0, cfg.n_classes, size=cfg.n_samples).astype(np.int32)
    centers = rng.randn(cfg.n_classes, cfg.feat_dim).astype(np.float32)
    if cfg.kind == "class_blobs":
        x = centers[labels] + cfg.noise * rng.randn(
            cfg.n_samples, cfg.feat_dim).astype(np.float32)
    elif cfg.kind == "mnist_like":
        masks = (rng.rand(cfg.n_classes, cfg.feat_dim) < 0.25)
        base = np.abs(centers)
        x = (base[labels] * masks[labels]).astype(np.float32)
        x += 0.1 * np.abs(rng.randn(cfg.n_samples, cfg.feat_dim)).astype(np.float32)
        x = np.clip(x / (x.max() + 1e-6), 0.0, 1.0)
    elif cfg.kind == "noisy_subspace":
        s = max(4, cfg.feat_dim // 8)
        sig_centers = rng.randn(cfg.n_classes, s).astype(np.float32)
        x = np.empty((cfg.n_samples, cfg.feat_dim), np.float32)
        x[:, :s] = sig_centers[labels] + cfg.noise * rng.randn(
            cfg.n_samples, s).astype(np.float32)
        x[:, s:] = 3.0 * rng.randn(
            cfg.n_samples, cfg.feat_dim - s).astype(np.float32)
    elif cfg.kind == "llc_like":
        # sparse nonnegative codes: class-specific support + magnitude noise
        masks = (rng.rand(cfg.n_classes, cfg.feat_dim) < (1.0 - cfg.sparsity))
        mags = np.abs(centers)
        x = (mags[labels] * masks[labels]).astype(np.float32)
        x += cfg.noise * np.abs(
            rng.randn(cfg.n_samples, cfg.feat_dim)).astype(np.float32) * masks[labels]
    else:
        raise ValueError(f"unknown kind {cfg.kind}")
    return x, labels


def _draw_pair_indices(rng, labels: np.ndarray, n_pairs: int,
                       want_same: bool, dedup: bool = True):
    """Rejection-sample (a, b) index pairs of the requested kind.

    Self-pairs (a == b) are always masked. With ``dedup`` (default),
    duplicate constraints within the draw are dropped too, treating
    (a, b) and (b, a) as the same unordered constraint.
    """
    n = labels.shape[0]
    a = np.empty(n_pairs, np.int64)
    b = np.empty(n_pairs, np.int64)
    # canonical min*n+max keys taken so far, kept SORTED: membership is a
    # searchsorted per round and the merge a linear insert
    seen = np.empty(0, np.int64)
    filled = 0
    stalled = 0
    grow = 1        # oversample factor; doubles when a round finds nothing
    while filled < n_pairs:
        m = min(max(2 * (n_pairs - filled) * grow, 64), 1 << 22)
        ca = rng.randint(0, n, size=m)
        cb = rng.randint(0, n, size=m)
        same = labels[ca] == labels[cb]
        keep = (same if want_same else ~same) & (ca != cb)
        ca, cb = ca[keep], cb[keep]
        if dedup and len(ca):
            key = np.minimum(ca, cb) * n + np.maximum(ca, cb)
            _, first = np.unique(key, return_index=True)
            first.sort()               # keep draw order (determinism)
            ca, cb, key = ca[first], cb[first], key[first]
            pos = np.searchsorted(seen, key)
            found = np.zeros(len(key), bool)
            inside = pos < len(seen)
            found[inside] = seen[pos[inside]] == key[inside]
            ca, cb, key = ca[~found], cb[~found], key[~found]
            take = min(len(ca), n_pairs - filled)
            new = np.sort(key[:take])
            seen = np.insert(seen, np.searchsorted(seen, new), new)
        k = min(len(ca), n_pairs - filled)
        a[filled:filled + k] = ca[:k]
        b[filled:filled + k] = cb[:k]
        filled += k
        if k == 0:
            stalled += 1
            grow = min(grow * 2, 1 << 16)
        else:
            stalled = 0
        if stalled >= 64:
            raise ValueError(
                f"could not draw {n_pairs} distinct "
                f"{'similar' if want_same else 'dissimilar'} pairs from "
                f"{n} rows (only {filled} exist under the labeling)")
    return a, b


def sample_pairs(features: np.ndarray, labels: np.ndarray, n_similar: int,
                 n_dissimilar: int, seed: int = 0, dedup: bool = True):
    """Sample S and D as in the paper: same class -> similar, else
    dissimilar. Returns dict(xs, ys, sim) of numpy arrays, xs/ys
    (n_s+n_d, d), sim in {1, 0}."""
    rng = np.random.RandomState(seed)
    sa, sb = _draw_pair_indices(rng, labels, n_similar, True, dedup)
    da, db = _draw_pair_indices(rng, labels, n_dissimilar, False, dedup)
    xs = np.concatenate([features[sa], features[da]], axis=0)
    ys = np.concatenate([features[sb], features[db]], axis=0)
    sim = np.concatenate([np.ones(n_similar, np.int32),
                          np.zeros(n_dissimilar, np.int32)])
    perm = rng.permutation(xs.shape[0])
    return {"xs": xs[perm], "ys": ys[perm], "sim": sim[perm]}


def sample_pair_indices(labels: np.ndarray, n_similar: int,
                        n_dissimilar: int, seed: int = 0,
                        dedup: bool = True):
    """Index-only pair sampling: returns dict(a, b, sim) of int arrays —
    O(n_pairs) memory instead of O(n_pairs * d)."""
    rng = np.random.RandomState(seed)
    sa, sb = _draw_pair_indices(rng, labels, n_similar, True, dedup)
    da, db = _draw_pair_indices(rng, labels, n_dissimilar, False, dedup)
    a = np.concatenate([sa, da])
    b = np.concatenate([sb, db])
    sim = np.concatenate([np.ones(n_similar, np.int32),
                          np.zeros(n_dissimilar, np.int32)])
    perm = rng.permutation(a.shape[0])
    return {"a": a[perm], "b": b[perm], "sim": sim[perm]}


def distinct_draws(rng, n_pool: int, size: int) -> np.ndarray:
    """``size`` distinct uniform draws from range(n_pool), O(size)
    expected when size << n_pool; replacement draws only when the pool is
    smaller than the batch."""
    if size > n_pool:
        return rng.randint(0, n_pool, size)
    if 4 * size >= n_pool:              # dense: permutation is cheapest
        return rng.permutation(n_pool)[:size]
    out = np.unique(rng.randint(0, n_pool, size))
    while len(out) < size:
        out = np.union1d(out, rng.randint(0, n_pool, 2 * (size - len(out))))
    return out[rng.permutation(len(out))[:size]]


def _batch_rows(sim: np.ndarray, batch_size: int, seed: int,
                balanced: bool) -> Iterator[np.ndarray]:
    """Row indices of each batch: half S / half D when ``balanced`` (paper
    §5.2), distinct within the batch."""
    rng = np.random.RandomState(seed)
    sim_idx = np.nonzero(sim == 1)[0]
    dis_idx = np.nonzero(sim == 0)[0]
    while True:
        if balanced and len(sim_idx) and len(dis_idx):
            h = batch_size // 2
            yield np.concatenate([
                sim_idx[distinct_draws(rng, len(sim_idx), h)],
                dis_idx[distinct_draws(rng, len(dis_idx), batch_size - h)]])
        else:
            yield distinct_draws(rng, sim.shape[0], batch_size)


def pair_batches_from_indices(features, idx_pairs: dict, batch_size: int,
                              seed: int = 0, balanced: bool = True,
                              device=None) -> Iterator[dict]:
    """Minibatch stream gathering features on the fly (memory-bounded).

    ``features`` (numpy or tensor) is placed on ``device`` (the card by
    default) once; each batch's rows are gathered there by index, so no
    feature bytes cross to the device per step. Constraints within a
    batch are distinct.
    """
    dev = resolve_device(device)
    store = torch.as_tensor(features).to(dev)

    def stream():
        for sel in _batch_rows(idx_pairs["sim"], batch_size, seed, balanced):
            a = torch.from_numpy(idx_pairs["a"][sel]).to(dev)
            b = torch.from_numpy(idx_pairs["b"][sel]).to(dev)
            yield {"xs": store[a], "ys": store[b],
                   "sim": torch.from_numpy(idx_pairs["sim"][sel]).to(dev)}

    return stream()


def pair_batches(pairs: dict, batch_size: int, seed: int = 0,
                 balanced: bool = True, device=None) -> Iterator[dict]:
    """Infinite minibatch stream of a materialized pair dict, as tensors on
    ``device`` (the card by default). ``balanced`` draws half S / half D
    per batch as in the paper's experimental setup (§5.2). Constraints
    within a batch are distinct."""
    dev = resolve_device(device)

    def stream():
        for idx in _batch_rows(pairs["sim"], batch_size, seed, balanced):
            yield {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(dev)
                   for k, v in pairs.items()}

    return stream()


def train_eval_split(cfg: PairDatasetConfig, n_train_sim: int,
                     n_train_dis: int, n_eval_sim: int, n_eval_dis: int):
    """Features + disjoint train/eval pair sets (paper's held-out pair
    eval), numpy."""
    x, y = make_features(cfg)
    n_hold = max(cfg.n_samples // 5, 2 * cfg.n_classes)
    train_x, train_y = x[:-n_hold], y[:-n_hold]
    hold_x, hold_y = x[-n_hold:], y[-n_hold:]
    train_pairs = sample_pairs(train_x, train_y, n_train_sim, n_train_dis,
                               seed=cfg.seed + 1)
    eval_pairs = sample_pairs(hold_x, hold_y, n_eval_sim, n_eval_dis,
                              seed=cfg.seed + 2)
    return train_pairs, eval_pairs


def sample_triplet_indices(labels: np.ndarray, n_triplets: int,
                           seed: int = 0):
    """(anchor, positive, negative) index triples — the paper's §4
    triple-wise constraint extension."""
    rng = np.random.RandomState(seed)
    n = labels.shape[0]
    a = np.empty(n_triplets, np.int64)
    p = np.empty(n_triplets, np.int64)
    ng = np.empty(n_triplets, np.int64)
    filled = 0
    while filled < n_triplets:
        ca = rng.randint(0, n, size=2 * (n_triplets - filled))
        cp = rng.randint(0, n, size=2 * (n_triplets - filled))
        cn = rng.randint(0, n, size=2 * (n_triplets - filled))
        keep = ((labels[ca] == labels[cp]) & (labels[ca] != labels[cn])
                & (ca != cp))
        k = min(keep.sum(), n_triplets - filled)
        a[filled:filled + k] = ca[keep][:k]
        p[filled:filled + k] = cp[keep][:k]
        ng[filled:filled + k] = cn[keep][:k]
        filled += k
    return {"a": a, "p": p, "n": ng}


def triplet_batches_from_indices(features, idx: dict, batch_size: int,
                                 seed: int = 0, device=None):
    """Minibatch stream of {anchor, pos, neg} gathered on ``device`` (the
    card by default) from a feature store placed there once."""
    dev = resolve_device(device)
    store = torch.as_tensor(features).to(dev)

    def stream():
        rng = np.random.RandomState(seed)
        n = idx["a"].shape[0]
        while True:
            sel = rng.randint(0, n, batch_size)
            yield {name: store[torch.from_numpy(idx[key][sel]).to(dev)]
                   for name, key in (("anchor", "a"), ("pos", "p"),
                                     ("neg", "n"))}

    return stream()
