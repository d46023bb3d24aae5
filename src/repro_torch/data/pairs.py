"""Synthetic class-structured features mirroring the paper's setup (§5.1).

Counterpart of ``PairDatasetConfig`` and ``make_features`` in
``repro/data/pairs.py``: the same numpy ``RandomState`` draws in the same
order, so both packages give byte-identical features and labels for
every ``kind``. Pair sampling belongs to the training slice.

  * ``class_blobs``    — Gaussian blobs around random class centers;
  * ``mnist_like``     — nonnegative, bounded, class-dependent masks;
  * ``noisy_subspace`` — class signal in a small subspace under noise;
  * ``llc_like``       — sparse nonnegative codes mimicking LLC features
                         (the ImageNet-63K / ImageNet-1M configs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
