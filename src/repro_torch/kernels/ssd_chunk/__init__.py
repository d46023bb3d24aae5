from repro_torch.kernels.ssd_chunk.ops import ssd_core  # noqa: F401
from repro_torch.kernels.ssd_chunk.kernel import (  # noqa: F401
    segment_plan, ssd_scan,
)
from repro_torch.kernels.ssd_chunk.ref import (  # noqa: F401
    CHUNK, ssd_scan_chunked, ssd_scan_ref, ssd_scan_segmented,
)
