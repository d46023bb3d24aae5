from repro_torch.kernels.pairwise_dist.ops import (  # noqa: F401
    metric_sqdist_matrix, pairwise_sqdist_any,
)
from repro_torch.kernels.pairwise_dist.kernel import pairwise_sqdist  # noqa: F401
from repro_torch.kernels.pairwise_dist.ref import pairwise_sqdist_ref  # noqa: F401
