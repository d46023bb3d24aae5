from repro_torch.kernels.metric_topk.ops import (  # noqa: F401
    metric_topk, metric_topk_plain, project_gallery,
)
from repro_torch.kernels.metric_topk.kernel import metric_topk_fused  # noqa: F401
from repro_torch.kernels.metric_topk.ref import (  # noqa: F401
    metric_sqdist_factored, metric_topk_naive, metric_topk_ref,
)
