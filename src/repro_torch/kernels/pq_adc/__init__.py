"""Fused PQ ADC segment scan: uint8 code gather + LUT sum + top-k.

``ops.pq_adc_topk`` is the public dispatcher (CUDA tensors -> the
hand-written kernel, CPU tensors -> the plain version);
``kernel.pq_adc_topk_fused`` the ctypes wrapper of ``csrc/pq_adc.cu``;
``ref.pq_adc_topk_ref`` the bit-exact plain version.
"""

from repro_torch.kernels.pq_adc.kernel import pq_adc_topk_fused  # noqa: F401
from repro_torch.kernels.pq_adc.ops import pq_adc_topk  # noqa: F401
from repro_torch.kernels.pq_adc.ref import pq_adc_topk_ref  # noqa: F401
