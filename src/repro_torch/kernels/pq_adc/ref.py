"""Plain PyTorch version of the fused PQ ADC segment scan.

Counterpart of ``repro/kernels/pq_adc/ref.py``, and bit for bit the same
function: gather each query's probed code segments, pick the
per-subspace lookup-table entries, apply the ADC identity

    d = max((d_cent + t) - 2 * sum_s LUT[s, code_s], 0)

and keep the kk best (distance, id) candidates. Two choices carry the
bit-identity contract (with the JAX reference and with the kernel):

  * the subspace sum is a **sequential** loop (``ip = ip + picked[s]``),
    never ``.sum(-1)``, whose reduction order is unspecified;
  * candidates flatten probe-major / slot-minor, the order the kernel
    streams them in, so position-order tie-breaks agree.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import topk_by_distance


def pq_adc_topk_ref(tables, dc, probes, codes, t, ids, kk: int):
    """ADC-score the probed segments and keep the top kk per query.

    Args:
      tables: (Nq, S*K) flattened per-query inner-product LUTs.
      dc: (Nq, nprobe) squared centroid distances of the probed clusters.
      probes: (Nq, nprobe) probed cluster ids.
      codes: (C, cap, S) uint8 segment codes (0 on pad slots).
      t: (C, cap) f32 baked row terms (+BIG on pad slots).
      ids: (C, cap) int32 global row ids (-1 on pad slots).
      kk: candidates kept per query (<= nprobe * cap).

    Returns (dists (Nq, kk) f32 ascending, ids (Nq, kk) int32), sorted
    lexicographically by (distance, id).
    """
    Nq, nprobe = probes.shape
    S = codes.shape[2]
    K = tables.shape[1] // S
    seg = probes.long()
    cg = codes[seg]                                  # (Nq, np, cap, S) u8
    offs = torch.arange(S, device=codes.device) * K
    fl = cg.long() + offs
    picked = torch.gather(tables, 1, fl.reshape(Nq, -1))
    picked = picked.reshape(Nq, nprobe, cg.shape[2], S)
    ip = picked[..., 0]
    for s in range(1, S):                            # sequential: see module
        ip = ip + picked[..., s]                     # docstring
    d = torch.clamp_min(dc[:, :, None] + t[seg] - 2.0 * ip, 0.0)
    return topk_by_distance(d.reshape(Nq, -1), ids[seg].reshape(Nq, -1), kk)
