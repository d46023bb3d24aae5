"""Shared gallery-scan machinery: projection, row sharding, selection.

Counterpart of ``repro/serve/scan.py``:

  * ``project_queries``   — q @ L^T, the once-per-query projection;
  * ``check_metric_factor`` — the (d_out, d_in) contract, re-exported;
  * ``SCAN_IMPLS`` / ``resolve_scan_impl`` — the segment-scan knob of the
    IVF / IVFPQ indexes, kept with the reference's three values;
  * ``recall_at_k``       — host-side overlap metric;
  * ``local_topk`` / ``topk_by_distance`` — candidate selection; the
    latter is the deterministic (distance, id) merge;
  * ``gallery_axes`` / ``put_row_sharded`` / ``shard_index`` — the
    logical "gallery" axis over a live mesh
    (``launch/mesh.LiveMesh``, one process a rank): each rank holds its
    block of rows;
  * ``build_sharded_topk`` — each rank turns its rows into at most
    ``kk`` candidates with global ids, the candidates are gathered, and
    one (distance, id) merge makes the answer exact;
  * ``lead`` / ``follow`` — serving a sharded index from rank 0.

A sharded index's ``topk`` is collective: every rank calls it with the
same queries. A front end (engine, batcher, scheduler) runs on rank 0
only, since its batches depend on wall time: it serves what
``lead(index)`` yields, which broadcasts each call (k_top, nprobe and
the raw queries: each rank's kernel projects them, as on one device)
before making it, while the other ranks ``follow(index)``, making the
same call, until rank 0 leaves ``lead``. A call that raises on rank 0
once announced ends the group, so that the followers fail at once
instead of pairing with the wrong collective.
Snapshots and ``MutableIndex`` take single-shard indexes only, as the
reference's do (its ``serve/mutable.py`` and ``serve/snapshot.py``
refuse sharded bases).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import _dispatch
from repro_torch.launch.mesh import LiveMesh
from repro_torch.sharding import partition


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


# -- row sharding over a live mesh -------------------------------------------

def gallery_axes(mesh: LiveMesh,
                 n_rows: Optional[int] = None) -> Tuple[str, ...]:
    """Mesh axes the gallery rows shard over (possibly empty: rows that
    do not divide the shard count are replicated). ``n_rows=None`` skips
    the divisibility check, for IVF, which rounds its cluster count up
    to a multiple of the shards."""
    partition.require_live(mesh, "a sharded gallery")
    shape = None if n_rows is None else (n_rows, 1)
    ax = partition.logical_to_physical(("gallery", None), mesh,
                                       shape=shape)[0]
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def row_axis(axes: Tuple[str, ...]):
    """Spec entry for the row dimension (one axis or a tuple)."""
    return axes if len(axes) > 1 else axes[0]


def n_shards(mesh: Optional[LiveMesh], axes: Tuple[str, ...]) -> int:
    return mesh.axis_size(axes) if axes else 1


def shard_index(mesh: LiveMesh, axes: Tuple[str, ...]) -> int:
    """This rank's spec-major shard id along ``axes``."""
    return mesh.axis_index(axes) if axes else 0


def put_row_sharded(mesh: LiveMesh, axes: Tuple[str, ...], arr):
    """This rank's block of the leading dim of the global ``arr`` over
    the gallery axes, a copy of its own on the rank's device."""
    arr = torch.as_tensor(arr)
    return partition.block(arr, (row_axis(axes),), mesh).to(
        mesh.device, copy=True)


def build_sharded_topk(mesh: LiveMesh, axes: Tuple[str, ...],
                       local_candidates: Callable, k_top: int):
    """The local-topk / global-merge skeleton over this rank's rows.

    ``local_candidates(shard, qp, *extras) -> (d, ids)`` runs on each
    rank over the rows it holds: ``shard`` is its shard id, ``qp`` the
    queries every rank holds (in the form ``local_candidates`` takes
    them), ``extras`` further per-call inputs. It returns (Nq, kk)
    candidates with global row ids, kk >= min(k_top, the candidates the
    shard has) and the same on every shard; the candidates of all shards
    are gathered (shard order along the neighbour axis) and one
    (distance, id) merge makes the answer exact. Returns ``run(qp,
    *extras) -> (dists, ids)``, which every rank calls.
    """
    shard = shard_index(mesh, axes)

    def run(qp, *extras):
        d, ids = local_candidates(shard, qp, *extras)
        cand_d = partition.all_gather(d.contiguous(), axes, mesh)
        cand_i = partition.all_gather(ids.contiguous(), axes, mesh)
        nq = d.shape[0]
        return topk_by_distance(cand_d.transpose(0, 1).reshape(nq, -1),
                                cand_i.transpose(0, 1).reshape(nq, -1),
                                k_top)

    return run


# -- serving a sharded index from rank 0 -------------------------------------

_CALL, _STOP = 1, 0


def _header(mesh: LiveMesh, *fields) -> torch.Tensor:
    return torch.tensor(fields, dtype=torch.int64, device=mesh.device)


class LeadIndex:
    """What ``lead`` yields on rank 0: the sharded index, with each
    ``topk`` broadcast to the followers before it is made (one call at a
    time); every other attribute is the index's."""

    def __init__(self, index):
        self._index, self._lock = index, threading.Lock()
        self._ended = False     # left ``lead``, or the group was ended

    def __getattr__(self, name):
        return getattr(self._index, name)

    def topk(self, queries, k_top: int, nprobe: Optional[int] = None):
        index, mesh = self._index, self._index.mesh
        q = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
        nq, d = q.shape
        with self._lock:
            if self._ended:
                raise RuntimeError("this lead has ended (left, or a call "
                                   "failed and ended the group)")
            try:
                mesh.broadcast(_header(mesh, _CALL, k_top,
                                       -1 if nprobe is None else nprobe,
                                       nq, d))
                mesh.broadcast(q.contiguous())
                return index.topk(q, k_top, **(
                    {} if nprobe is None else {"nprobe": nprobe}))
            except BaseException:
                # the followers wait in this call's collectives (or raised
                # as rank 0 did): end the group so that they fail now
                self._ended = True
                dist.destroy_process_group()
                raise

    def _stop(self) -> None:
        with self._lock:
            if not self._ended:
                self._ended = True
                mesh = self._index.mesh
                mesh.broadcast(_header(mesh, _STOP, 0, 0, 0, 0))


@contextlib.contextmanager
def lead(index):
    """On rank 0: yields what to serve the sharded ``index`` through (the
    index, each ``topk`` announced to the ranks in ``follow(index)``);
    leaving the block stops them. An index that is not sharded is
    yielded as it is."""
    if index.n_shards == 1:
        yield index
        return
    if index.mesh.rank != 0:
        raise ValueError("rank 0 leads a sharded index; the others follow")
    led = LeadIndex(index)
    try:
        yield led
    finally:
        led._stop()


def follow(index) -> int:
    """On the ranks other than 0: make each call that rank 0 announces
    on the sharded ``index`` (its share of the collective ``topk``)
    until rank 0 leaves ``lead``. Returns the number of calls served."""
    if index.n_shards == 1:
        return 0
    mesh, n = index.mesh, 0
    while True:
        head = mesh.broadcast(_header(mesh, 0, 0, 0, 0, 0))
        op, k_top, nprobe, nq, d = head.tolist()
        if op == _STOP:
            return n
        q = mesh.broadcast(torch.empty((nq, d), dtype=torch.float32,
                                       device=mesh.device))
        index.topk(q, k_top, **({} if nprobe < 0 else {"nprobe": nprobe}))
        n += 1
