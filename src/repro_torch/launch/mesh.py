"""Mesh shapes and the card's figures (counterpart of
``repro/launch/mesh.py``).

A mesh here is a named shape, axis name -> size, with no process group
behind it: what the sharding plan (``sharding/partition.py``) and the
dry-run account (``launch/dryrun.py``) read. A ``DeviceMesh`` over a live
process group comes with the multi-GPU slice (ROADMAP.md Queue 1 item 8).

This module is the one source of the H100's figures: the dry-run's
roofline terms and ``chip_smoke.py``'s per-kernel bounds read them from
here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# NVIDIA H100 SXM5 80GB at its 700 W limit, dense rates (no sparsity),
# NVIDIA's data sheet
CARD = "H100 SXM5 80GB, 700 W"
PEAK_FLOPS_BF16 = 989e12        # bf16 / fp16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12        # TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # f32 FFMA, outside the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
HBM_BYTES = 80e9
NVLINK_BW = 450e9               # bytes/s per direction

# The rate each dtype's products run at on the port's plain paths. f32
# products are full f32 (``kernels/_dispatch.full_f32`` turns TF32 off),
# so they run at the FFMA rate; the hand-written kernels' f32 products
# are 3xTF32, PEAK_FLOPS_TF32 / 3, above it.
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": PEAK_FLOPS_BF16,
    "float16": PEAK_FLOPS_BF16,
    "float32": PEAK_FLOPS_F32,
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh shape: ``axis_names`` with ``axis_sizes``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh() -> Mesh:
    """The one-card shape, (data=1, model=1)."""
    return Mesh(("data", "model"), (1, 1))


# The meshes the dry-run account names: the one card, and the two
# production meshes its sharding plan reads
MESHES = {"h100": make_local_mesh(),
          "16x16": make_production_mesh(),
          "pod2x16x16": make_production_mesh(multi_pod=True)}
