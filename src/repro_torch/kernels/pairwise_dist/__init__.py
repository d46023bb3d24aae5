"""Plain all-pairs metric distances (the kernel is ported later)."""

from repro_torch.kernels.pairwise_dist.ref import pairwise_sqdist_ref  # noqa: F401
