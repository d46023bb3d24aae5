"""Downstream tasks the paper motivates DML with (§1: retrieval, k-means
clustering, kNN classification), evaluated under a learned metric.

Counterpart of ``repro/core/eval_tasks.py``. kNN distances go through
``kernels/pairwise_dist.metric_sqdist_matrix``: the hand-written kernel
on the card, its plain version on the CPU. Because M = LᵀL factorizes,
every task is Euclidean geometry in the projected space x -> L x, so
k-means stays exact Lloyd iterations there. Each entry point runs on the
card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import full_f32
from repro_torch.kernels.pairwise_dist import metric_sqdist_matrix


def _on(x, dev, dtype=None):
    return torch.as_tensor(x, dtype=dtype).to(dev)


def knn_vote(D, train_y, k: int = 5):
    """Majority label among each row's k nearest columns of the (n_test,
    n_train) distance matrix ``D``. Neighbours come from a stable
    ascending sort, so equal distances go to the smaller training index
    (as ``lax.top_k(-D)``); a tied vote goes to the smallest label (first
    maximum)."""
    nn = torch.sort(D, dim=1, stable=True).indices[:, :min(k, D.shape[1])]
    votes = train_y[nn].long()                           # (n_test, k)
    n_classes = int(torch.max(train_y)) + 1
    counts = torch.zeros((D.shape[0], n_classes), dtype=torch.int64,
                         device=D.device)
    counts.scatter_add_(1, votes, torch.ones_like(votes))
    return torch.argmax(counts, dim=1)


def knn_classify(L: Optional[torch.Tensor], train_x, train_y, test_x,
                 k: int = 5, device=None):
    """k-nearest-neighbour labels under the metric (L=None -> Euclidean)."""
    dev = resolve_device(device)
    train_x = _on(train_x, dev, torch.float32)
    test_x = _on(test_x, dev, torch.float32)
    if L is None:
        L = torch.eye(train_x.shape[1], dtype=torch.float32, device=dev)
    D = metric_sqdist_matrix(_on(L, dev), test_x, train_x)
    return knn_vote(D, _on(train_y, dev), k)


def knn_accuracy(L, train_x, train_y, test_x, test_y, k: int = 5,
                 device=None) -> float:
    dev = resolve_device(device)
    pred = knn_classify(L, train_x, train_y, test_x, k, device=dev)
    return float(torch.mean((pred == _on(test_y, dev)).to(torch.float32)))


def metric_kmeans(L: Optional[torch.Tensor], x, n_clusters: int,
                  n_iter: int = 25, seed: int = 0, device=None):
    """Lloyd k-means in the learned metric space. Returns (assignments,
    centers_in_projected_space)."""
    dev = resolve_device(device)
    full_f32()
    x = _on(x, dev, torch.float32)
    xp = x @ _on(L, dev, torch.float32).T if L is not None else x
    n = xp.shape[0]
    rng = np.random.RandomState(seed)
    centers = xp[torch.from_numpy(rng.choice(n, n_clusters,
                                             replace=False)).to(dev)]
    xn = torch.sum(xp ** 2, 1)[:, None]
    assign = None
    for _ in range(n_iter):
        d = xn + torch.sum(centers ** 2, 1)[None] - 2 * xp @ centers.T
        assign = torch.argmin(d, dim=1)
        onehot = torch.nn.functional.one_hot(
            assign, n_clusters).to(torch.float32)
        members = onehot.sum(0)
        new_centers = (onehot.T @ xp) / torch.clamp_min(members, 1.0)[:, None]
        # keep empty clusters where they were
        centers = torch.where((members > 0)[:, None], new_centers, centers)
    return assign, centers


def clustering_purity(assignments, labels) -> float:
    """Fraction of points whose cluster's majority label matches theirs."""
    assignments, labels = (x.cpu().numpy() if torch.is_tensor(x)
                           else np.asarray(x) for x in (assignments, labels))
    total = 0
    for c in np.unique(assignments):
        member_labels = labels[assignments == c]
        if len(member_labels):
            total += np.bincount(member_labels).max()
    return total / len(labels)
