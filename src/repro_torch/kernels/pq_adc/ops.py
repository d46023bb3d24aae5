"""Public wrapper of the fused PQ ADC scan: validation + dispatch.

Counterpart of ``repro/kernels/pq_adc/ops.py``. ``pq_adc_topk`` is the
one entry point serve/pq.py calls; it goes by the tensors' device, with
no knob and no fallback:

  * validation (kk >= 1 and within the probed candidate pool), with the
    reference's messages;
  * CPU tensors: the plain version (ref.py), chunked over ``block_q``
    query rows so the gathered (block_q, nprobe, cap, S) intermediate
    stays bounded;
  * CUDA tensors: the hand-written kernel (kernel.py), then d >= BIG
    survivors masked to id -1 and the final (distance, id) sort.

Both paths return bit-identical arrays, distances and ids.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dispatch import (check_kk, finish_segment_scan,
                                         map_query_chunks)
from repro_torch.kernels.pq_adc.kernel import pq_adc_topk_fused
from repro_torch.kernels.pq_adc.ref import pq_adc_topk_ref


def pq_adc_topk(tables, dc, probes, codes, t, ids, *, kk: int,
                block_q: int = 64):
    """Top-kk ADC candidates per query from its probed code segments.

    Args:
      tables: (Nq, S*K) flattened per-query LUTs.
      dc: (Nq, nprobe) squared centroid distances of the probed clusters.
      probes: (Nq, nprobe) probed cluster ids.
      codes: (C, cap, S) uint8; t: (C, cap) f32 (+BIG pads);
        ids: (C, cap) int32 (-1 pads) — the IVFPQ segment layout.
      kk: candidates kept per query (1 <= kk <= nprobe * cap).
      block_q: query chunk of the plain (CPU) path.

    Returns (dists (Nq, kk) f32 ascending, ids (Nq, kk) int32), sorted
    lexicographically by (distance, id); -1 ids mark under-filled probes.
    """
    C, cap, S = codes.shape
    check_kk(kk, probes.shape[1], cap)
    if not tables.is_cuda:
        return map_query_chunks(
            lambda tab, d, pr: pq_adc_topk_ref(tab, d, pr, codes, t, ids, kk),
            (tables, dc, probes), block_q, kk)
    return finish_segment_scan(*pq_adc_topk_fused(
        probes.to(torch.int32).contiguous(),
        tables.to(torch.float32).contiguous(),
        dc.to(torch.float32).contiguous(),
        codes.reshape(C * cap, S).contiguous(),
        t.reshape(C * cap).to(torch.float32).contiguous(),
        ids.reshape(C * cap).to(torch.int32).contiguous(),
        n_codes=tables.shape[1] // S, cap=cap, kk=kk))
