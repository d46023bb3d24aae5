"""Public wrappers for the fused metric top-k kernel.

The serving contract (serve/index.py builds on this):

  * ``project_gallery``    — the once-per-index amortization: gp = G @ L^T
    and its row norms. Everything at query time is d_out-dimensional.
  * ``metric_topk``        — dispatch by device: a CUDA tensor goes to the
    hand-written kernel (kernel.py), a CPU tensor to the plain version.
    There is no knob and no fallback: a failed build or launch raises.
  * ``metric_topk_plain``  — the factored plain path (counterpart of the
    reference's ``metric_topk_xla``), also the kernel's yardstick.

Float32 products run in full f32 (``_dispatch.full_f32`` in
``project_gallery`` and the plain path), so the port agrees with its
plain version on the card and with the JAX reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import check_metric_factor, full_f32
from repro_torch.kernels.metric_topk.kernel import metric_topk_fused
from repro_torch.kernels.metric_topk.ref import metric_topk_ref


def project_gallery(L: torch.Tensor, gallery: torch.Tensor):
    """Pre-project the gallery once: returns (gp (M,d_out) f32, gn (M,)
    f32). ``L`` is (d_out, d_in), square or rectangular."""
    check_metric_factor(L, gallery.shape[-1])
    full_f32()
    gp = gallery.to(torch.float32) @ L.to(torch.float32).T
    gn = torch.sum(torch.square(gp), dim=1)
    return gp, gn


def metric_topk_plain(L, queries, gp, gn, k_top: int):
    """Factored plain path: project queries, reuse the gallery norms,
    stable-sort selection."""
    full_f32()
    qp = queries.to(torch.float32) @ L.to(torch.float32).T
    return metric_topk_ref(qp, gp, k_top, gn)


def metric_topk(L, queries, gp, gn=None, *, k_top: int = 10):
    """Top-k gallery neighbors of raw queries under the metric L^T L.

    Args:
      L: (d_out, d_in) metric factor — square or rectangular (low rank).
      queries: (Nq, d_in) raw queries (bf16 inputs are cast to f32).
      gp: (M, d_out) pre-projected gallery (see project_gallery).
      gn: optional (M,) precomputed gp row norms.

    Returns (dists (Nq, k_top) f32 ascending, indices (Nq, k_top) int32).
    """
    Nq, d = queries.shape
    check_metric_factor(L, d)
    M = gp.shape[0]
    if k_top > M:
        raise ValueError(f"k_top={k_top} > gallery size M={M}")
    gp = gp.to(torch.float32)
    if gn is None:
        gn = torch.sum(torch.square(gp), dim=1)
    if not queries.is_cuda:
        return metric_topk_plain(L, queries, gp, gn, k_top)
    return metric_topk_fused(
        queries.to(torch.float32).contiguous(),
        L.to(torch.float32).contiguous(), gp.contiguous(),
        gn.to(torch.float32).contiguous(), k_top=k_top)
