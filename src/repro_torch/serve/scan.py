"""Shared gallery-scan machinery (single device): projection, selection.

Counterpart of the single-device parts of ``repro/serve/scan.py``:

  * ``project_queries``   — q @ L^T, the once-per-query projection;
  * ``check_metric_factor`` — the (d_out, d_in) contract, re-exported;
  * ``SCAN_IMPLS`` / ``resolve_scan_impl`` — the segment-scan knob of the
    IVF / IVFPQ indexes, kept with the reference's three values;
  * ``recall_at_k``       — host-side overlap metric;
  * ``local_topk`` / ``topk_by_distance`` — candidate selection; the
    latter is the deterministic (distance, id) merge.

Row sharding over several cards belongs to the multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _dispatch


def project_queries(L, queries):
    """Project raw (Nq, d_in) queries into the d_out-dim metric space (f32)."""
    check_metric_factor(L, queries.shape[-1])
    _dispatch.full_f32()
    return queries.to(torch.float32) @ L.to(torch.float32).T


def check_metric_factor(L, d_in=None, *, what: str = "L"):
    """Validate L against the (d_out, d_in) contract — see
    kernels/_dispatch.check_metric_factor."""
    return _dispatch.check_metric_factor(L, d_in, what=what)


SCAN_IMPLS = ("auto", "xla", "pallas")


def resolve_scan_impl(default: str, override=None, device=None) -> str:
    """Resolve the segment-scan knob for an index on ``device``.

    The port keeps the reference's three values so a stored knob round
    trips, but dispatch goes by device and the knob can only confirm it:
    on a CUDA index "auto" and "pallas" mean the hand-written kernel
    (returns "pallas") and "xla" raises — the port has no XLA path, and
    its plain version runs on an index built with ``device="cpu"``; on a
    CPU index "auto" and "xla" mean the plain version (returns "xla") and
    "pallas" raises, since the kernel needs the card. ``override`` is a
    per-call value (None defers to ``default``; ``is None``, never
    truthiness).
    """
    impl = default if override is None else override
    if impl not in SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {impl!r} "
                         f"({'|'.join(SCAN_IMPLS)})")
    on_card = torch.device(device if device is not None else "cpu").type \
        == "cuda"
    if on_card and impl == "xla":
        raise ValueError(
            "scan_impl='xla' names the reference's XLA path, which the port "
            "does not have: on a CUDA index the scan is the hand-written "
            "kernel ('auto' or 'pallas'); build the index with device='cpu' "
            "for the plain version")
    if not on_card and impl == "pallas":
        raise ValueError(
            "scan_impl='pallas' names the kernel, which needs a CUDA index; "
            "a CPU index runs the plain version ('auto' or 'xla')")
    return "pallas" if on_card else "xla"


def recall_at_k(approx_ids, exact_ids) -> float:
    """Mean per-query overlap |approx ∩ exact| / k between two (Nq, k)
    neighbor-id arrays. -1 sentinel ids never match a real id."""
    a = np.asarray(approx_ids)
    e = np.asarray(exact_ids)
    k = e.shape[1]
    return float(np.mean([len(set(ar[ar >= 0]) & set(er)) / k
                          for ar, er in zip(a, e)]))


def local_topk(d, ids, kk: int):
    """Cheapest local selection: stable sort on d, ties toward the earlier
    candidate position. Correct merge input whenever candidate position
    order equals global-id order (the contiguous row scan)."""
    pos = torch.sort(d, dim=-1, stable=True).indices[..., :kk]
    return torch.gather(d, -1, pos), torch.gather(ids, -1, pos)


def topk_by_distance(d, ids, k_top: int):
    """Top-k candidates with equal distances smallest-id-first — see
    kernels/_dispatch.topk_by_distance."""
    return _dispatch.topk_by_distance(d, ids, k_top)
