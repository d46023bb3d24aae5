"""Index hierarchy: the MetricIndex protocol and the exact scan backend.

Counterpart of ``repro/serve/index.py``. Index build amortizes the
learned metric once (``gp = G @ L^T`` plus row norms,
kernels/metric_topk.project_gallery); every query then costs
O(d_in*d_out + M*d_out). ``topk`` goes through ``metric_topk``, which on
the card launches the hand-written kernel and on the CPU runs its plain
version. ``ExactIndex.backend`` keeps the reference's engine knob:
"auto" (that dispatch by device), "pallas" (the kernel; needs the card,
raises on a CPU index) or "xla" (the plain path, ``metric_topk_plain``,
on the index's device, the card included).

Over a live mesh the rows shard over the logical "gallery" axis (rows
that do not divide the shard count are replicated) and ``topk`` is
collective (serve/scan.py): each rank scans its rows with the same
dispatch, kernel or plain, at ``kk = min(k_top, rows_local)`` and adds
its row offset, and the gathered candidates merge exactly. The
reference refuses its fused kernel when sharded only because a Pallas
kernel does not compose with ``shard_map``; a per-rank call does, so the
knob keeps its one-device meaning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.metric_topk import (metric_topk, metric_topk_plain,
                                             project_gallery)
from repro_torch.serve import scan


@runtime_checkable
class MetricIndex(Protocol):
    """What the serving engine needs from any retrieval index backend."""

    version: int        # bumped on gallery mutation -> engine cache flush

    @property
    def size(self) -> int: ...          # number of real gallery rows

    @property
    def n_shards(self) -> int: ...      # devices the rows live on

    def topk(self, queries, k_top: int):
        """(dists (Nq, k_top) ascending, global row ids (Nq, k_top))."""
        ...


BACKENDS = ("auto", "xla", "pallas")


@dataclasses.dataclass(eq=False)
class ExactIndex:
    """Immutable exact retrieval index over a pre-projected gallery.

    ``gp`` holds ``gallery @ L^T`` and ``gn`` its row norms, both f32 on
    ``L``'s device; answers are exact for the stored rows, equal
    distances toward the smaller row id.
    """

    L: torch.Tensor                 # (d_out, d_in) metric factor
    gp: torch.Tensor                # (M, d_out) projected gallery rows
    gn: torch.Tensor                # (M,) row norms of gp
    version: int = 0
    backend: str = "auto"           # auto | pallas (kernel) | xla (plain)
    mesh: Optional[object] = None   # a LiveMesh the rows shard over
    axes: Tuple[str, ...] = ()      # mesh axes of the rows (gp: this
    n_rows: Optional[int] = None    # rank's block of n_rows rows)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"({'|'.join(BACKENDS)})")

    @classmethod
    def build(cls, L, gallery, device=None, backend: str = "auto",
              mesh=None) -> "ExactIndex":
        """Project the (M, d_in) gallery through L once (on ``device``,
        the card by default). With a live ``mesh`` every rank passes the
        whole gallery and projects only its own rows, on the mesh's
        device (``device`` is ignored)."""
        M = len(gallery)
        if mesh is None:
            dev, axes = resolve_device(device), ()
            gallery = torch.as_tensor(gallery).to(dev)
        else:
            dev, axes = mesh.device, scan.gallery_axes(mesh, M)
            gallery = scan.put_row_sharded(mesh, axes, gallery) if axes \
                else torch.as_tensor(gallery).to(dev)
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        gp, gn = project_gallery(L, gallery)
        idx = cls.from_projected(L, gp, gn, device=dev, backend=backend)
        return idx if mesh is None else idx._on(mesh, axes, M)

    @classmethod
    def from_projected(cls, L, gp, gn, device=None, backend: str = "auto",
                       mesh=None) -> "ExactIndex":
        """Construct from already-projected rows (gp (M,d_out), gn (M,)).
        With a live ``mesh`` every rank passes all rows and keeps its
        own block, or all of them when M does not divide the shards."""
        if mesh is not None:
            M = len(gp)
            axes = scan.gallery_axes(mesh, M)
            if axes:
                gp = scan.put_row_sharded(mesh, axes, gp)
                gn = scan.put_row_sharded(mesh, axes, gn)
            return cls.from_projected(L, gp, gn, device=mesh.device,
                                      backend=backend)._on(mesh, axes, M)
        dev = resolve_device(device)
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        scan.check_metric_factor(L)
        gp = torch.as_tensor(gp, dtype=torch.float32).to(dev).contiguous()
        if gp.shape[1] != L.shape[0]:
            raise ValueError(
                f"projected rows have dim {gp.shape[1]} but L is "
                f"{tuple(L.shape)}; gp must be sized d_out")
        gn = torch.as_tensor(gn, dtype=torch.float32).to(dev).contiguous()
        return cls(L=L.contiguous(), gp=gp, gn=gn, backend=backend)

    def _on(self, mesh, axes, n_rows: int) -> "ExactIndex":
        self.mesh, self.axes, self.n_rows = mesh, tuple(axes), n_rows
        return self

    @property
    def device(self) -> torch.device:
        return self.gp.device

    @property
    def size(self) -> int:
        """Number of gallery rows (over every shard)."""
        return self.gp.shape[0] if self.n_rows is None else self.n_rows

    @property
    def n_shards(self) -> int:
        """Mesh shards the rows live on (1 when unsharded)."""
        return scan.n_shards(self.mesh, self.axes)

    def topk(self, queries, k_top: int):
        """Exact k nearest gallery rows per raw (Nq, d_in) query.

        Returns (dists (Nq, k_top) f32 ascending, row indices (Nq, k_top)
        int32); equal distances tie toward the smaller id. Collective on
        a sharded index: every rank calls it with the same queries.
        """
        if k_top > self.size:
            raise ValueError(f"k_top={k_top} > gallery size {self.size}")
        if self.backend == "pallas" and self.device.type != "cuda":
            raise ValueError("backend 'pallas' is the metric_topk kernel, "
                             "which needs the card; this index is on "
                             f"{self.device}")
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        if self.n_shards == 1:
            return self._scan(q, k_top)
        kk = min(k_top, self.gp.shape[0])   # per-shard candidates: exact

        def local_candidates(shard, q):
            d, i = self._scan(q, kk)
            return d, i + shard * self.gp.shape[0]

        return scan.build_sharded_topk(self.mesh, self.axes,
                                       local_candidates, k_top)(q)

    def _scan(self, q, k_top: int):
        """This rank's rows: the kernel on the card (or the plain path
        under backend "xla"), its plain version on the CPU."""
        if self.backend == "xla":
            return metric_topk_plain(self.L, q, self.gp, self.gn, k_top)
        return metric_topk(self.L, q, self.gp, self.gn, k_top=k_top)


# Back-compat name of the reference's first exact backend.
GalleryIndex = ExactIndex
