"""Index hierarchy: the MetricIndex protocol and the exact scan backend.

Counterpart of ``repro/serve/index.py`` on one device (no mesh). Index
build amortizes the learned metric once (``gp = G @ L^T`` plus row norms,
kernels/metric_topk.project_gallery); every query then costs
O(d_in*d_out + M*d_out). ``topk`` goes through ``metric_topk``, which on
the card launches the hand-written kernel and on the CPU runs its plain
version. ``ExactIndex.backend`` keeps the reference's engine knob:
"auto" (that dispatch by device), "pallas" (the kernel; needs the card,
raises on a CPU index) or "xla" (the plain path, ``metric_topk_plain``,
on the index's device, the card included).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

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

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"({'|'.join(BACKENDS)})")

    @classmethod
    def build(cls, L, gallery, device=None,
              backend: str = "auto") -> "ExactIndex":
        """Project the (M, d_in) gallery through L once (on ``device``,
        the card by default)."""
        dev = resolve_device(device)
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        gallery = torch.as_tensor(gallery).to(dev)
        gp, gn = project_gallery(L, gallery)
        return cls.from_projected(L, gp, gn, device=dev, backend=backend)

    @classmethod
    def from_projected(cls, L, gp, gn, device=None,
                       backend: str = "auto") -> "ExactIndex":
        """Construct from already-projected rows (gp (M,d_out), gn (M,))."""
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

    @property
    def device(self) -> torch.device:
        return self.gp.device

    @property
    def size(self) -> int:
        """Number of gallery rows."""
        return self.gp.shape[0]

    @property
    def n_shards(self) -> int:
        return 1

    def topk(self, queries, k_top: int):
        """Exact k nearest gallery rows per raw (Nq, d_in) query.

        Returns (dists (Nq, k_top) f32 ascending, row indices (Nq, k_top)
        int32); equal distances tie toward the smaller id.
        """
        if k_top > self.size:
            raise ValueError(f"k_top={k_top} > gallery size {self.size}")
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        if self.backend == "xla":
            return metric_topk_plain(self.L, q, self.gp, self.gn, k_top)
        if self.backend == "pallas" and self.device.type != "cuda":
            raise ValueError("backend 'pallas' is the metric_topk kernel, "
                             "which needs the card; this index is on "
                             f"{self.device}")
        return metric_topk(self.L, q, self.gp, self.gn, k_top=k_top)


# Back-compat name of the reference's first exact backend.
GalleryIndex = ExactIndex
