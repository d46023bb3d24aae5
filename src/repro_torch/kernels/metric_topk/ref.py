"""Plain PyTorch versions of the fused metric top-k retrieval kernel.

  * ``metric_topk_ref``   — factored-form distances on *projected* points
    and a stable sort: the kernel's plain version (same math, same
    tie-breaking: the smaller gallery index wins on equal distance).
  * ``metric_topk_naive`` — the textbook per-pair Mahalanobis baseline:
    apply ``L`` to every (query - gallery) difference.

Selection is a **stable** ``torch.sort`` along the gallery axis sliced to
``k_top``, never ``torch.topk``, whose order among equal values is
unspecified: with a stable sort ties go to the smaller gallery index,
exactly as ``lax.top_k`` does in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_dist.ref import pairwise_sqdist_ref


def metric_sqdist_factored(qp, gp, gn=None):
    """Squared distances between projected queries (Nq,k) and projected
    gallery (M,k): D[i,j] = ||qp_i||^2 + ||gp_j||^2 - 2 qp_i . gp_j >= 0."""
    return pairwise_sqdist_ref(qp, gp, gn)


def _smallest(d, k_top: int):
    srt = torch.sort(d, dim=1, stable=True)
    return (srt.values[:, :k_top].contiguous(),
            srt.indices[:, :k_top].to(torch.int32).contiguous())


def metric_topk_ref(qp, gp, k_top: int, gn=None):
    """Top-k nearest gallery rows per projected query.

    Returns (dists (Nq, k_top) f32 ascending, indices (Nq, k_top) int32).
    """
    return _smallest(metric_sqdist_factored(qp, gp, gn), k_top)


def metric_topk_naive(L, queries, gallery, k_top: int, chunk: int = 4):
    """Unamortized baseline: project each (query - gallery point)
    difference through L, chunked over queries to bound the (c, M, d)
    difference tensor. Same answers as metric_topk_ref on projected
    inputs."""
    L = L.to(torch.float32)
    queries = queries.to(torch.float32)
    gallery = gallery.to(torch.float32)
    dists, idxs = [], []
    for s in range(0, queries.shape[0], chunk):
        z = queries[s:s + chunk, None, :] - gallery[None, :, :]
        d = torch.sum(torch.square(z @ L.T), dim=-1)     # (c, M)
        dd, ii = _smallest(d, k_top)
        dists.append(dd)
        idxs.append(ii)
    return torch.cat(dists, dim=0), torch.cat(idxs, dim=0)
