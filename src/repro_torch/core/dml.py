"""Core distance-metric-learning objectives from Xie & Xing (2014).

Counterpart of ``repro/core/dml.py``. Both the original constrained SDP
form (Eq. 1 pieces, for the Xing 2002 baseline) and the paper's
parallelizable reformulation (Eq. 4):

    min_L  sum_{(x,y) in S} ||L(x-y)||^2
         + lambda * sum_{(x,y) in D} max(0, 1 - ||L(x-y)||^2)

``M = L^T L`` with ``L`` of shape ``(d_out, d_in)``, ``d_out <= d_in``; a
rectangular (low-rank) L keeps M PSD by construction. Everything here is
plain PyTorch on whatever device its tensors live on; float32 products
run in full f32 (``kernels/_dispatch.full_f32``). The training loss goes
through the fused kernel instead (``core/losses.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._dispatch import full_f32


@dataclasses.dataclass(frozen=True)
class DMLConfig:
    """Hyper-parameters of the reformulated DML objective (paper §3/§5.2).

    ``proj_dim`` and ``l_rank`` are two names for ``d_out``, the rows of
    the learned (d_out, d_in) factor. Setting neither gives a square
    factor; setting both to different values is an error.
    ``compute_dtype`` casts the plain path's products (e.g. bf16); the
    CUDA kernel takes f32 only and refuses any other.
    """

    feat_dim: int                     # d_in — feature dimensionality
    proj_dim: Optional[int] = None    # d_out — rows of L (<= d_in)
    lam: float = 1.0        # lambda — dissimilar-pair tradeoff (paper: 1)
    margin: float = 1.0     # c — dissimilarity margin (paper: 1)
    dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None
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


def mahalanobis_sqdist(L, x, y, compute_dtype=None):
    """||L(x - y)||^2 for batched x, y of shape (..., d). Returns (...,)."""
    full_f32()
    z = x - y
    if compute_dtype is not None:
        z = z.to(compute_dtype)
        L = L.to(compute_dtype)
    proj = z @ L.T                      # (..., k)
    return torch.sum(torch.square(proj.to(torch.float32)), dim=-1)


def pair_losses(L, xs, ys, sim, lam: float = 1.0, margin: float = 1.0,
                compute_dtype=None):
    """Per-pair Eq. 4 loss: ``||L(x-y)||^2`` for similar pairs (sim 1),
    ``lam * max(0, margin - ||L(x-y)||^2)`` for dissimilar ones (sim 0).
    L (k, d); xs, ys (B, d); sim (B,). Returns (B,)."""
    d2 = mahalanobis_sqdist(L, xs, ys, compute_dtype)
    sim = sim.to(d2.dtype)
    hinge = torch.clamp_min(margin - d2, 0.0)
    return sim * d2 + (1.0 - sim) * lam * hinge


def objective(L, xs, ys, sim, lam: float = 1.0, margin: float = 1.0,
              compute_dtype=None):
    """Mean Eq. 4 objective over a minibatch of pairs (scalar)."""
    return torch.mean(pair_losses(L, xs, ys, sim, lam, margin,
                                  compute_dtype))


def objective_value_and_grad(L, xs, ys, sim, lam: float = 1.0,
                             margin: float = 1.0, compute_dtype=None):
    """(objective, d objective / d L) by autograd — what each PS worker
    computes from its local pair shard (paper §4.1)."""
    with torch.enable_grad():
        Lv = L.detach().requires_grad_(True)
        val = objective(Lv, xs, ys, sim, lam, margin, compute_dtype)
        (g,) = torch.autograd.grad(val, Lv)
    return val.detach(), g


def objective_full(L, xs, ys, sim, lam: float = 1.0, margin: float = 1.0):
    """Sum-form objective as written in Eq. 4 (not mean-normalized)."""
    return torch.sum(pair_losses(L, xs, ys, sim, lam, margin))


def analytic_grad(L, xs, ys, sim, lam: float = 1.0, margin: float = 1.0):
    """Closed-form minibatch-mean gradient of Eq. 4 w.r.t. L.

    dL ||Lz||^2 = 2 L z z^T; for dissimilar pairs inside the hinge the
    sign flips and picks up lambda. An independent oracle for autograd
    and for the kernel's backward.
    """
    full_f32()
    z = xs - ys                                   # (B, d)
    d2 = mahalanobis_sqdist(L, xs, ys)            # (B,)
    sim_f = sim.to(L.dtype)
    active = (d2 < margin).to(L.dtype)            # hinge active mask
    w = sim_f - lam * (1.0 - sim_f) * active      # (B,)
    Lz = z @ L.T                                  # (B, k)
    g = 2.0 * (Lz * w[:, None]).T @ z / xs.shape[0]
    return g.to(L.dtype)


# ---------------------------------------------------------------------------
# Original formulation (Eq. 1) pieces — used by the xing2002 baseline.
# ---------------------------------------------------------------------------

def mahalanobis_sqdist_M(M, x, y):
    """(x-y)^T M (x-y) for batched inputs."""
    full_f32()
    z = x - y
    return torch.einsum("...d,de,...e->...", z, M, z)


def psd_project(M):
    """Project a symmetric matrix onto the PSD cone via eigendecomposition
    (the O(d^3) step the paper's reformulation removes)."""
    full_f32()
    M = 0.5 * (M + M.T)
    w, V = torch.linalg.eigh(M)
    w = torch.clamp_min(w, 0.0)
    return (V * w[None, :]) @ V.T


def M_from_L(L):
    """Recover the Mahalanobis matrix M = L^T L (guaranteed PSD)."""
    full_f32()
    return L.T @ L


# ---------------------------------------------------------------------------
# Triplet extension (paper §4: triple-wise constraints).
# ---------------------------------------------------------------------------

def triplet_losses(L, anchor, pos, neg, margin: float = 1.0,
                   compute_dtype=None):
    """max(0, margin + ||L(a-p)||^2 - ||L(a-n)||^2) per triplet."""
    d_pos = mahalanobis_sqdist(L, anchor, pos, compute_dtype)
    d_neg = mahalanobis_sqdist(L, anchor, neg, compute_dtype)
    return torch.clamp_min(margin + d_pos - d_neg, 0.0)


def triplet_objective(L, anchor, pos, neg, margin: float = 1.0,
                      compute_dtype=None):
    return torch.mean(triplet_losses(L, anchor, pos, neg, margin,
                                     compute_dtype))


# ---------------------------------------------------------------------------
# Evaluation (paper §5.4): threshold distances to classify pairs as
# similar/dissimilar; report average precision and precision-recall curves.
# ---------------------------------------------------------------------------

def pair_scores(L, xs, ys):
    """Similarity score = negative Mahalanobis distance (higher = more
    similar)."""
    return -mahalanobis_sqdist(L, xs, ys)


def pair_scores_euclidean(xs, ys):
    return -torch.sum(torch.square(xs - ys), dim=-1)


def pair_scores_M(M, xs, ys):
    return -mahalanobis_sqdist_M(M, xs, ys)


def average_precision(scores, labels):
    """AP of ranking similar pairs (labels==1) above dissimilar (labels==0):
    sum_k P(k) * rel(k) / n_pos over the score-descending ranking (stable
    on ties, as the reference's argsort)."""
    order = torch.argsort(-scores, stable=True)
    rel = labels.to(torch.float32)[order]
    cum_pos = torch.cumsum(rel, dim=0)
    ranks = torch.arange(1, rel.shape[0] + 1, dtype=torch.float32,
                         device=rel.device)
    precision_at_k = cum_pos / ranks
    n_pos = torch.clamp_min(torch.sum(rel), 1.0)
    return torch.sum(precision_at_k * rel) / n_pos


def precision_recall_curve(scores, labels, n_points: int = 100):
    """(precision, recall) arrays swept over score thresholds (numpy,
    eval-only; tensors are copied to the host)."""
    scores, labels = (x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x) for x in (scores, labels))
    labels = labels.astype(np.float64)
    order = np.argsort(-scores)
    rel = labels[order]
    tp = np.cumsum(rel)
    fp = np.cumsum(1.0 - rel)
    n_pos = max(rel.sum(), 1.0)
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    idx = np.linspace(0, len(rel) - 1, min(n_points, len(rel))).astype(int)
    return precision[idx], recall[idx]
