"""IVF (inverted-file) cluster-pruned ANN index under the learned metric.

Counterpart of ``repro/serve/ivf.py`` on one device. Build: k-means in
the *projected* k-dim metric space (Lloyd's, farthest-point seeding,
empty clusters reseeded at the worst-served rows) partitions the
pre-projected gallery into ``n_clusters`` contiguous segments, each
padded to a common capacity ``cap``. Query: score the C centroids, keep
the ``nprobe`` nearest clusters, scan only their segments with the
factored distance and the (distance, id) top-k — the ``ivf_scan``
kernel on the card, its plain version on the CPU.

Per-query row visits drop from M to ``nprobe * cap``. With ``nprobe ==
n_clusters`` every row is visited and the ids match ExactIndex whenever
distances are distinct. Pad slots carry ``gn = +BIG`` / ``id = -1``
sentinels and surface only when the probed clusters hold fewer than
k_top real rows.

The k-means, the balanced assignment and the cluster-major layout are
plain torch on the index's device (the reference computes them outside
any kernel too). The layout is built there, without a host copy of the
projected rows: a stable sort by cluster, then row order, gives the
reference's slots.

Over a live mesh (``mesh=``) the index keeps whole clusters a shard, as
the reference does: the cluster count rounds up to a multiple of the
shards, rank 0 runs the k-means and the balanced assignment on the
whole gallery (every rank passes it) and broadcasts the centroids and
the assignment, and each rank lays out its own clusters' segments plus
one all-sentinel segment (``BIG`` norms, id -1). A query's probes that
other shards own point at that segment, so each rank's ``ivf_scan``
launch takes the one-device probe shape; ``topk`` is collective
(serve/scan.py) and the gathered candidates merge exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import BIG
from repro_torch.kernels.ivf_scan import ivf_scan_topk
from repro_torch.kernels.metric_topk import (metric_sqdist_factored,
                                             project_gallery)
from repro_torch.kernels.pairwise_dist.ref import pairwise_sqdist_ref
from repro_torch.serve import scan
from repro_torch.sharding import partition

_ROW_BLOCK = 131_072        # rows per pass of the row-wise build loops
_SUM_COLS = 256             # columns per pass of the k-means cluster sums


# -- metric-space k-means ----------------------------------------------------

def _assign(gp, centroids, block_rows: int = 16384):
    """Nearest-centroid assignment, chunked over rows so the (M, C)
    distance matrix never materializes at big M. Returns (assign (M,)
    int64, min_sqdist (M,) f32); ties go to the smaller centroid id."""
    a, md = [], []
    for s in range(0, gp.shape[0], block_rows):
        d = pairwise_sqdist_ref(gp[s:s + block_rows], centroids)
        i = torch.argmin(d, dim=1)
        a.append(i)
        md.append(torch.gather(d, 1, i[:, None])[:, 0])
    return torch.cat(a), torch.cat(md)


def _row_sqdist(gp, x):
    """||gp_i - x||^2 for every row, in row blocks (the reference's
    direct form, not the factored one)."""
    return torch.cat([torch.sum(torch.square(gp[s:s + _ROW_BLOCK] - x), dim=1)
                      for s in range(0, gp.shape[0], _ROW_BLOCK)])


def _farthest_init(gp, n_clusters: int, start: int):
    """k-center greedy ("maxmin") seeding from row ``start``: repeatedly
    take the row farthest from every seed so far (first index on ties).
    Returns (n_clusters, k) seeds."""
    mind = torch.full((gp.shape[0],), float("inf"), dtype=torch.float32,
                      device=gp.device)
    last = gp[start]
    seeds = [last]
    for _ in range(n_clusters - 1):
        mind = torch.minimum(mind, _row_sqdist(gp, last))
        last = gp.index_select(0, torch.argmax(mind).view(1))[0]
        seeds.append(last)
    return torch.stack(seeds)


def _cluster_sums(gp, a, n_clusters: int):
    """(C, k) sum of each cluster's rows, added in row order.

    A segment sum over the rows sorted (stably) by cluster, _SUM_COLS
    columns at a time so the sorted copy stays small: deterministic on the
    card, where ``index_add_`` adds with float atomics in whatever order
    the threads land (two builds of one index then differ in the last
    bits), and bit-equal to ``index_add_`` on the CPU."""
    order = torch.sort(a, stable=True).indices
    counts = torch.bincount(a, minlength=n_clusters)
    return torch.cat([torch.segment_reduce(gp[:, c:c + _SUM_COLS][order],
                                           "sum", lengths=counts, axis=0)
                      for c in range(0, gp.shape[1], _SUM_COLS)], dim=1)


def _lloyd(gp, cent0, iters: int, block_rows: int = 16384):
    """``iters`` Lloyd steps from ``cent0``. Returns (centroids (C, k),
    objective (iters,)): objective[t] is the mean squared distance to the
    nearest centroid entering step t. An empty cluster reseeds at a
    distinct currently worst-served row (largest min-distance)."""
    M = gp.shape[0]
    C = cent0.shape[0]
    cent = cent0
    objective = []
    for _ in range(iters):
        a, md = _assign(gp, cent, block_rows)
        counts = torch.bincount(a, minlength=C).to(torch.float32)
        sums = _cluster_sums(gp, a, C)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        empty = counts == 0.0
        far = torch.sort(-md, stable=True).indices
        rank = torch.clamp(torch.cumsum(empty, 0) - 1, 0, M - 1)
        cent = torch.where(empty[:, None], gp[far[rank]], new)
        objective.append(md.mean())
    return cent, torch.stack(objective) if objective else \
        torch.zeros((0,), device=gp.device)


def kmeans_projected(gp, n_clusters: int, *, iters: int = 10, seed: int = 0,
                     block_rows: int = 16384, init: str = "farthest",
                     start: Optional[int] = None):
    """Lloyd's k-means over pre-projected rows (M, k), on gp's device.

    ``init``: "farthest" (k-center greedy from one row; default) or
    "random" (distinct row draws). The starting row / draws come from a
    ``torch.Generator`` seeded with ``seed`` (not the reference's PRNG:
    the two packages seed differently); ``start`` fixes the first
    farthest-point row, so a run can start where the reference's did.

    Returns (centroids (C, k) f32, assign (M,) int64, objective (iters,)
    f32), objective as in ``_lloyd``.
    """
    gp = gp.to(torch.float32)
    M = gp.shape[0]
    if n_clusters > M:
        raise ValueError(f"n_clusters={n_clusters} > gallery size {M}")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if init == "farthest":
        if start is None:
            start = int(torch.randint(0, M, (1,), generator=gen))
        cent0 = _farthest_init(gp, n_clusters, int(start))
    elif init == "random":
        cent0 = gp[torch.randperm(M, generator=gen)[:n_clusters]
                   .to(gp.device)]
    else:
        raise ValueError(f"unknown init {init!r}")
    centroids, objective = _lloyd(gp, cent0, iters, block_rows)
    assign, _ = _assign(gp, centroids, block_rows)
    return centroids, assign, objective


def _balance_assign(gp, centroids, assign, cap: int):
    """Capacity-bounded assignment: clusters keep their ``cap`` closest
    rows; overflow rows move, in order, to the nearest cluster with free
    space.

    The reference runs this on the host in numpy; here the distances run
    on gp's device and only the greedy placement walks the host. Sorts
    are stable, so equal distances go to the smaller row / cluster id.
    Total capacity C * cap >= M, so every row is placed.
    """
    C = centroids.shape[0]
    counts = torch.bincount(assign, minlength=C)
    if int(counts.max()) <= cap:
        return assign
    order = torch.sort(assign, stable=True).indices     # rows by cluster
    offsets = (torch.cumsum(counts, 0) - counts).tolist()
    spilled = []
    for c in torch.nonzero(counts > cap).flatten().tolist():
        rows = order[offsets[c]:offsets[c] + int(counts[c])]
        d = torch.sum(torch.square(gp[rows] - centroids[c]), dim=1)
        spilled.append(rows[torch.sort(d, stable=True).indices[cap:]])
    spilled = torch.cat(spilled)
    counts = torch.clamp_max(counts, cap).cpu().numpy()
    cn = torch.sum(torch.square(centroids), dim=1)
    placed = []
    for s in range(0, len(spilled), 4096):
        g = gp[spilled[s:s + 4096]]
        d_all = (torch.sum(torch.square(g), dim=1)[:, None] + cn[None, :]
                 - 2.0 * g @ centroids.T)                   # (B, C)
        pref = torch.sort(d_all, dim=1, stable=True).indices.cpu().numpy()
        placed.append(_place_in_order(pref, counts, cap))
    assign = assign.clone()
    assign[spilled] = torch.from_numpy(np.concatenate(placed)).to(
        assign.device)
    return assign


def _place_in_order(pref: np.ndarray, counts: np.ndarray, cap: int):
    """Give each row, in order, the first cluster of its preference list
    (a row of ``pref``) with fewer than ``cap`` rows; ``counts`` is
    updated in place. The same placement as one row at a time, taken in
    vectorized runs: every row of a run takes its first free cluster as
    of the run's start, and a run ends where that cluster has filled
    since (at most once per cluster filling up)."""
    out = np.empty(len(pref), np.int64)
    i = 0
    while i < len(pref):
        full = counts >= cap
        rest = pref[i:]
        choice = rest[np.arange(len(rest)), np.argmax(~full[rest], axis=1)]
        by_c = np.argsort(choice, kind="stable")
        first = np.searchsorted(choice[by_c], choice[by_c], side="left")
        rank = np.empty(len(rest), np.int64)
        rank[by_c] = np.arange(len(rest)) - first      # earlier rows, same c
        bad = np.flatnonzero(rank >= cap - counts[choice])
        n = len(rest) if len(bad) == 0 else int(bad[0])
        out[i:i + n] = choice[:n]
        np.add.at(counts, choice[:n], 1)
        i += n
    return out


def segment_layout(assign, n_clusters: int, cap: int):
    """Cluster-major slots: (order, slots) with row ``order[j]`` at slot
    ``slots[j]`` — clusters in id order, rows of a cluster in row order
    (a stable sort by cluster), cluster c's rows from slot c * cap."""
    M = assign.shape[0]
    counts = torch.bincount(assign, minlength=n_clusters)
    order = torch.sort(assign, stable=True).indices
    offsets = torch.cumsum(counts, 0) - counts
    a = assign[order]
    within = torch.arange(M, device=assign.device) - offsets[a]
    return order, a * cap + within


def capacity(M: int, n_clusters: int, cap_factor: float) -> int:
    """Segment capacity: ceil(cap_factor * M / C), rounded up to 8."""
    cap = int(-((-max(cap_factor, 1.0) * M) // n_clusters))
    return ((cap + 7) // 8) * 8


class StepClock:
    """Seconds of successive build steps into ``out`` (when given), each
    step ended by a device synchronisation; a step lapped again adds to
    its entry."""

    def __init__(self, device: torch.device, out: Optional[dict]):
        self.device, self.out, self.t = device, out, time.perf_counter()

    def lap(self, name: str):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + t - self.t
        self.t = t


def _check_rows(L, gp, n_clusters: int) -> None:
    """The build's argument checks: the rows against L, the cluster
    count against the rows."""
    scan.check_metric_factor(L)
    M, k = gp.shape
    if k != L.shape[0]:
        raise ValueError(
            f"projected rows have dim {k} but L is {tuple(L.shape)}; gp "
            f"must be sized d_out")
    if n_clusters > M:
        raise ValueError(f"n_clusters={n_clusters} > gallery size {M}")


def _clusters(gp, n_clusters: int, *, iters: int, seed: int,
              cap_factor: float, clock: StepClock):
    """k-means, the segment capacity and the balanced assignment:
    (centroids, assign, cap); laps "kmeans" on ``clock``."""
    centroids, assign, _ = kmeans_projected(gp, n_clusters, iters=iters,
                                            seed=seed)
    clock.lap("kmeans")
    cap = capacity(gp.shape[0], n_clusters, cap_factor)
    return centroids, _balance_assign(gp, centroids, assign, cap), cap


def cluster_segments(L, gp, n_clusters: int, *, iters: int, seed: int,
                     cap_factor: float, clock: StepClock):
    """The build steps IVF and IVFPQ share: check the rows against L,
    k-means, the segment capacity, the balanced assignment and the
    cluster-major slots. Returns (centroids, assign, cap, order, slots);
    laps "kmeans" on ``clock``."""
    _check_rows(L, gp, n_clusters)
    centroids, assign, cap = _clusters(gp, n_clusters, iters=iters,
                                       seed=seed, cap_factor=cap_factor,
                                       clock=clock)
    order, slots = segment_layout(assign, n_clusters, cap)
    return centroids, assign, cap, order, slots


def _shared_clusters(L, gp, n_clusters: int, mesh, *, iters: int, seed: int,
                     cap_factor: float, clock: StepClock):
    """``_clusters`` computed on rank 0 and broadcast, so that every rank
    lays out the same segments. Every rank checks the arguments first,
    so that a bad one raises on all of them before any collective."""
    _check_rows(L, gp, n_clusters)
    M, k = gp.shape
    if mesh.rank == 0:
        centroids, assign, cap = _clusters(
            gp, n_clusters, iters=iters, seed=seed, cap_factor=cap_factor,
            clock=clock)
    else:
        centroids = gp.new_empty((n_clusters, k))
        assign = torch.empty((M,), dtype=torch.int64, device=gp.device)
        cap = capacity(M, n_clusters, cap_factor)
    mesh.broadcast(centroids)
    mesh.broadcast(assign)
    return centroids, assign, cap


# -- the index ---------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class IVFIndex:
    """Cluster-pruned approximate retrieval index (MetricIndex backend).

    Invariants: segments are cluster-major with a common capacity; pad
    slots carry ``gn = +BIG`` / ``id = -1`` and surface only when the
    probed clusters hold fewer than k_top real rows; at ``nprobe ==
    n_clusters`` the ids match ExactIndex (ties between exactly
    duplicated rows at the k_top boundary excepted).
    """

    L: torch.Tensor                 # (k, d) metric factor
    centroids: torch.Tensor         # (C, k) cluster centers
    gp_pad: torch.Tensor            # (C*cap, k) cluster-major padded rows
    gn_pad: torch.Tensor            # (C*cap,) row norms; BIG on pad slots
    ids_pad: torch.Tensor           # (C*cap,) int32 row ids; -1 on pads
    cap: int                        # per-cluster segment capacity
    n_clusters: int
    nprobe: int                     # default clusters scanned per query
    n_rows: int                     # real (unpadded) gallery size M
    block_q: int = 16               # query chunk of the plain (CPU) scan
    # segment-scan knob, the reference's values: "auto", "pallas" (the
    # kernel; CUDA index) or "xla" (the plain version; CPU index) — see
    # scan.resolve_scan_impl
    scan_impl: str = "auto"
    version: int = 0
    mesh: Optional[object] = None   # a LiveMesh the clusters shard over
    axes: tuple = ()                # its gallery axes (the pads: this
    # rank's clusters, then the all-sentinel segment)

    @classmethod
    def build(cls, L, gallery, n_clusters: int = 64, nprobe: int = 8, *,
              iters: int = 10, seed: int = 0, cap_factor: float = 1.25,
              scan_impl: str = "auto", mesh=None, device=None) -> "IVFIndex":
        """Project the (M, d_in) gallery through L once (on ``device``, the
        card by default; on a mesh's device), cluster it, lay out padded
        segments."""
        dev = resolve_device(device) if mesh is None else \
            partition.require_live(mesh, "a sharded IVF index").device
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        gp, gn = project_gallery(L, torch.as_tensor(gallery).to(dev))
        return cls.build_projected(L, gp, gn, n_clusters=n_clusters,
                                   nprobe=nprobe, iters=iters, seed=seed,
                                   cap_factor=cap_factor,
                                   scan_impl=scan_impl, mesh=mesh,
                                   device=dev)

    @classmethod
    def build_projected(cls, L, gp, gn, n_clusters: int = 64,
                        nprobe: int = 8, *, iters: int = 10, seed: int = 0,
                        cap_factor: float = 1.25, scan_impl: str = "auto",
                        mesh=None, device=None,
                        timings: Optional[dict] = None) -> "IVFIndex":
        """Cluster + lay out already-projected rows (gp (M,k), gn (M,)).

        ``cap_factor`` bounds a segment at about cap_factor * M / C rows:
        k-means clusters larger than that spill their farthest rows to the
        nearest cluster with free space (see ``_balance_assign``).
        ``timings``, when given, receives the seconds of the build steps
        ("kmeans", "balance_layout"), each ended by a device
        synchronisation.
        """
        dev = resolve_device(device) if mesh is None else \
            partition.require_live(mesh, "a sharded IVF index").device
        scan.resolve_scan_impl(scan_impl, device=dev)
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        gp = torch.as_tensor(gp, dtype=torch.float32).to(dev)
        gn = torch.as_tensor(gn, dtype=torch.float32).to(dev)
        clock = StepClock(dev, timings)
        axes = () if mesh is None else scan.gallery_axes(mesh)
        shards = scan.n_shards(mesh, axes)
        if shards == 1:
            centroids, _, cap, order, slots = cluster_segments(
                L, gp, n_clusters, iters=iters, seed=seed,
                cap_factor=cap_factor, clock=clock)
        else:   # whole clusters a shard; one k-means, on rank 0
            n_clusters = -(-n_clusters // shards) * shards
            centroids, assign, cap = _shared_clusters(
                L, gp, n_clusters, mesh, iters=iters, seed=seed,
                cap_factor=cap_factor, clock=clock)
            order, slots = segment_layout(assign, n_clusters, cap)
        (M, k), C = gp.shape, n_clusters
        # this shard's clusters, then (sharded) the all-sentinel segment
        C_loc = C // shards
        first = scan.shard_index(mesh, axes) * C_loc * cap if axes else 0
        if shards > 1:
            own = (slots >= first) & (slots < first + C_loc * cap)
            order, slots = order[own], slots[own] - first
        n_pad = (C_loc + (shards > 1)) * cap
        gp_pad = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
        for s in range(0, len(order), _ROW_BLOCK):
            gp_pad[slots[s:s + _ROW_BLOCK]] = gp[order[s:s + _ROW_BLOCK]]
        gn_pad = torch.full((n_pad,), BIG, dtype=torch.float32, device=dev)
        gn_pad[slots] = gn[order]
        ids_pad = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        ids_pad[slots] = order.to(torch.int32)
        clock.lap("balance_layout")
        return cls(L=L.contiguous(), centroids=centroids, gp_pad=gp_pad,
                   gn_pad=gn_pad, ids_pad=ids_pad, cap=cap, n_clusters=C,
                   nprobe=min(nprobe, C), n_rows=M, scan_impl=scan_impl,
                   mesh=mesh, axes=axes)

    @property
    def device(self) -> torch.device:
        return self.gp_pad.device

    @property
    def size(self) -> int:
        """Real (unpadded) gallery rows."""
        return self.n_rows

    @property
    def n_shards(self) -> int:
        """Mesh shards the clusters live on (1 when unsharded)."""
        return scan.n_shards(self.mesh, self.axes)

    def topk(self, queries, k_top: int, nprobe: Optional[int] = None,
             scan_impl: Optional[str] = None):
        """Approximate k nearest gallery rows per raw (Nq, d_in) query.

        ``nprobe`` defaults to the build setting (``n_clusters`` scans
        everything); ``scan_impl`` is checked against the index's device
        (scan.resolve_scan_impl). Returns (dists (Nq, k_top) f32
        ascending, row ids (Nq, k_top) int32); -1 ids mark under-filled
        probes (raise nprobe if callers see them). Collective on a
        sharded index: every rank calls it with the same queries.
        """
        if k_top > self.size:
            raise ValueError(f"k_top={k_top} > gallery size {self.size}")
        # `is None`, not truthiness: an explicit nprobe=0 must raise
        np_ = self.nprobe if nprobe is None else nprobe
        if np_ < 1:
            raise ValueError(f"nprobe must be >= 1, got {np_}")
        np_ = min(np_, self.n_clusters)
        if k_top > np_ * self.cap:
            raise ValueError(
                f"k_top={k_top} > nprobe*cap={np_ * self.cap} scanned "
                f"rows per query; raise nprobe")
        scan.resolve_scan_impl(self.scan_impl, scan_impl, self.device)
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        qp = scan.project_queries(self.L, q)
        probes, _ = probe(qp, self.centroids, np_)
        cap, k = self.cap, self.centroids.shape[1]
        segs = len(self.gn_pad) // cap
        g, gn, ids = (self.gp_pad.view(segs, cap, k),
                      self.gn_pad.view(segs, cap),
                      self.ids_pad.view(segs, cap))
        if self.n_shards == 1:
            return ivf_scan_topk(qp, probes, g, gn, ids, kk=k_top,
                                 block_q=self.block_q)
        C_loc = segs - 1

        def local_candidates(shard, qp, probes):
            slot = probes - shard * C_loc           # owned elsewhere: the
            slot = torch.where((slot >= 0) & (slot < C_loc), slot,
                               C_loc).to(torch.int32)   # sentinel segment
            return ivf_scan_topk(qp, slot.contiguous(), g, gn, ids,
                                 kk=min(k_top, np_ * cap),
                                 block_q=self.block_q)

        return scan.build_sharded_topk(self.mesh, self.axes,
                                       local_candidates, k_top)(qp, probes)


def probe(qp, centroids, nprobe: int):
    """Coarse quantizer: the nprobe nearest centroids of each projected
    query, ascending, ties to the lower cluster id (as ``lax.top_k(-cd)``).
    Returns (probes (Nq, nprobe) int32, their squared distances f32)."""
    cd = metric_sqdist_factored(qp, centroids)
    srt = torch.sort(cd, dim=1, stable=True)
    return (srt.indices[:, :nprobe].to(torch.int32).contiguous(),
            srt.values[:, :nprobe].contiguous())
