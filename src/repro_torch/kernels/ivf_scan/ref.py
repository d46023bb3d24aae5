"""Plain PyTorch version of the fused IVF full-precision segment scan.

Counterpart of ``repro/kernels/ivf_scan/ref.py``: gather each query's
probed segments (probe ids clipped into range, as the reference's
``mode="clip"``), score them with the factored squared distance

    d = max((||qp||² + gn) - 2 <qp, g_row>, 0)

and keep the kk best (distance, id) candidates. Candidates flatten
probe-major / slot-minor, the order the kernel streams them in, so the
position tie-break of ``topk_by_distance`` agrees with the kernel's.

``ivf_scan_grouped`` computes the same function in the kernel's order of
work: the (query, probe) pairs grouped by segment as the kernel's plan
groups them (``kernel.work_plan``), each group's chunk of segment rows
read once and scored against all of its pairs, one sorted (distance,
position) list per (pair, chunk), then the lists merged per query.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import (cdiv, full_f32, segment_split,
                                         sort_by_distance_id,
                                         topk_by_distance)
from repro_torch.kernels.ivf_scan.kernel import GROUP, TILE_ROWS, work_plan


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


def _by_distance_position(d, pos):
    """Order of (d, pos) ascending, lexicographically (pos unique)."""
    by_pos = torch.sort(pos, stable=True).indices
    by_d = torch.sort(d[by_pos], stable=True).indices
    return by_pos[by_d]


def ivf_scan_grouped(qp, probes, g, gn, ids, kk: int, n_sm: int = 132):
    """``ivf_scan_topk_ref`` in the kernel's order of work (module
    docstring): groups from ``work_plan``, row chunks from
    ``segment_split`` for ``n_sm`` SMs, per-(pair, chunk) lists of kk,
    merged by (distance, position). Same arguments and result."""
    full_f32()
    C, cap, k = g.shape
    nq, nprobe = probes.shape
    nchunk, rpc = segment_split(cdiv(nq * nprobe, GROUP), cap, n_sm,
                                TILE_ROWS)
    qp = qp.to(torch.float32)
    qn = torch.sum(torch.square(qp), dim=1)
    seg = probes.long().clamp(0, C - 1)
    lists = {}                                   # (q, p, c) -> (d, pos)
    for _, order, gfirst, gcount, gseg in work_plan(probes, C):
        for f, n, s in zip(gfirst.tolist(), gcount.tolist(), gseg.tolist()):
            pairs = order[f:f + n]
            q, p = pairs // nprobe, pairs % nprobe
            for c in range(nchunk):
                r0, r1 = c * rpc, min(cap, (c + 1) * rpc)
                x = g[s, r0:r1] @ qp[q].T        # the chunk read once
                d = torch.clamp_min(qn[q][None, :] + gn[s, r0:r1, None]
                                    - 2.0 * x, 0.0)
                for b in range(n):
                    pos = p[b] * cap + torch.arange(r0, r1, device=g.device)
                    o = _by_distance_position(d[:, b], pos)[:kk]
                    lists[int(q[b]), int(p[b]), c] = (d[o, b], pos[o])
    out_d, out_i = [], []
    for qi in range(nq):
        d = torch.cat([lists[qi, p, c][0] for p in range(nprobe)
                       for c in range(nchunk)])
        pos = torch.cat([lists[qi, p, c][1] for p in range(nprobe)
                         for c in range(nchunk)])
        o = _by_distance_position(d, pos)[:kk]
        out_d.append(d[o])
        out_i.append(ids[seg[qi, pos[o] // cap], pos[o] % cap])
    return sort_by_distance_id(torch.stack(out_d), torch.stack(out_i))
