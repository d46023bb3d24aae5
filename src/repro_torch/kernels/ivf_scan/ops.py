"""Public wrapper of the fused IVF segment scan: validation + dispatch.

Counterpart of ``repro/kernels/ivf_scan/ops.py``. ``ivf_scan_topk`` is
the one entry point serve/ivf.py calls; it goes by the tensors' device,
with no knob and no fallback:

  * validation (kk >= 1 and within the probed candidate pool), with the
    reference's messages;
  * CPU tensors: the plain version (ref.py), chunked over ``block_q``
    query rows so the gathered (block_q, nprobe, cap, k) intermediate
    stays bounded;
  * CUDA tensors: the hand-written kernel (kernel.py), then d >= BIG
    survivors masked to id -1 and the final (distance, id) sort.

Both paths agree on ids exactly and on distances to f32 rounding (the
k-contraction order differs).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import (check_kk, finish_segment_scan,
                                         map_query_chunks)
from repro_torch.kernels.ivf_scan.kernel import ivf_scan_topk_fused
from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref


def ivf_scan_topk(qp, probes, g, gn, ids, *, kk: int, block_q: int = 16):
    """Top-kk candidates per query from its probed segments.

    Args:
      qp: (Nq, k) projected queries.
      probes: (Nq, nprobe) probed cluster ids.
      g: (C, cap, k) segment rows; gn: (C, cap) norms (+BIG pads);
        ids: (C, cap) int32 row ids (-1 pads) — the IVF segment layout.
      kk: candidates kept per query (1 <= kk <= nprobe * cap).
      block_q: query chunk of the plain (CPU) path.

    Returns (dists (Nq, kk) f32 ascending, ids (Nq, kk) int32), sorted
    lexicographically by (distance, id); -1 ids mark under-filled probes.
    """
    C, cap, k = g.shape
    check_kk(kk, probes.shape[1], cap)
    if not qp.is_cuda:
        return map_query_chunks(
            lambda q, pr: ivf_scan_topk_ref(q, pr, g, gn, ids, kk),
            (qp, probes), block_q, kk)
    return finish_segment_scan(*ivf_scan_topk_fused(
        probes.to(torch.int32).contiguous(),
        qp.to(torch.float32).contiguous(),
        g.reshape(C * cap, k).to(torch.float32).contiguous(),
        gn.reshape(C * cap).to(torch.float32).contiguous(),
        ids.reshape(C * cap).to(torch.int32).contiguous(), cap=cap, kk=kk))
