"""Metric-space retrieval serving: exact index -> engine -> micro-batcher.

Counterpart of ``repro/serve`` for the exact single-device path: the
``MetricIndex`` protocol and ``ExactIndex`` (index.py) over the shared
projection/selection substrate (scan.py), a bucketed engine with a
hot-query LRU (engine.py), and the request-coalescing front door
(batcher.py), all timing on the injectable clock (clock.py). The device
path is kernels/metric_topk.
"""

from repro_torch.serve.batcher import MicroBatcher  # noqa: F401
from repro_torch.serve.clock import (Clock, FakeClock,  # noqa: F401
                                     SystemClock)
from repro_torch.serve.engine import RetrievalEngine  # noqa: F401
from repro_torch.serve.index import (ExactIndex, GalleryIndex,  # noqa: F401
                                     MetricIndex)
from repro_torch.serve.scan import recall_at_k  # noqa: F401
