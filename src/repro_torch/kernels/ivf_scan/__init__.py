"""Fused IVF segment scan: probed gather + factored distance + top-k.

``ops.ivf_scan_topk`` is the public dispatcher (CUDA tensors -> the
hand-written kernel, CPU tensors -> the plain version);
``kernel.ivf_scan_topk_fused`` the ctypes wrapper of ``csrc/ivf_scan.cu``;
``ref.ivf_scan_topk_ref`` the plain version and ``ref.ivf_scan_grouped``
the same in the kernel's order of work.
"""

from repro_torch.kernels.ivf_scan.kernel import ivf_scan_topk_fused  # noqa: F401
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk  # noqa: F401
from repro_torch.kernels.ivf_scan.ref import (  # noqa: F401
    ivf_scan_grouped, ivf_scan_topk_ref)
