"""Plain PyTorch version of the fused IVF full-precision segment scan.

Counterpart of ``repro/kernels/ivf_scan/ref.py``: gather each query's
probed segments (probe ids clipped into range, as the reference's
``mode="clip"``), score them with the factored squared distance

    d = max((||qp||² + gn) - 2 <qp, g_row>, 0)

and keep the kk best (distance, id) candidates. Candidates flatten
probe-major / slot-minor, the order the kernel streams them in, so the
position tie-break of ``topk_by_distance`` agrees with the kernel's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import full_f32, topk_by_distance


def ivf_scan_topk_ref(qp, probes, g, gn, ids, kk: int):
    """Score the probed segments of each query and keep the top kk.

    Args:
      qp: (Nq, k) projected queries.
      probes: (Nq, nprobe) probed cluster ids (clipped to [0, C)).
      g: (C, cap, k) segment rows (0 on pad slots).
      gn: (C, cap) row norms (+BIG on pad slots).
      ids: (C, cap) int32 global row ids (-1 on pad slots).
      kk: candidates kept per query (<= nprobe * cap).

    Returns (dists (Nq, kk) f32 ascending, ids (Nq, kk) int32), sorted
    lexicographically by (distance, id); -1 ids mark under-filled probes.
    """
    full_f32()
    seg = probes.long().clamp(0, g.shape[0] - 1)
    gg = g[seg]                                      # (Nq, np, cap, k)
    qp = qp.to(torch.float32)
    qn = torch.sum(torch.square(qp), dim=1)
    cross = torch.einsum("qpck,qk->qpc", gg, qp)
    d = torch.clamp_min(qn[:, None, None] + gn[seg] - 2.0 * cross, 0.0)
    Nq = qp.shape[0]
    return topk_by_distance(d.reshape(Nq, -1), ids[seg].reshape(Nq, -1), kk)
