"""Metric-space retrieval serving: index -> engine -> micro-batcher.

Counterpart of ``repro/serve`` for the single-device paths: the
``MetricIndex`` protocol and ``ExactIndex`` (index.py), the approximate
backends ``IVFIndex`` (ivf.py) and ``IVFPQIndex`` with its
``ProductQuantizer`` (pq.py), all over the shared projection/selection
substrate (scan.py), the mutation lifecycle layer (mutable.py
``MutableIndex``: upserts, deletes, compaction, metric hot-swap;
snapshot.py: save / load without re-projection, in the reference's
format), a bucketed engine with a hot-query LRU (engine.py), and the
request-coalescing front door (batcher.py), all timing on the
injectable clock (clock.py). The device paths are kernels/metric_topk,
kernels/ivf_scan and kernels/pq_adc.
"""

from repro_torch.serve.batcher import MicroBatcher  # noqa: F401
from repro_torch.serve.clock import (Clock, FakeClock,  # noqa: F401
                                     SystemClock)
from repro_torch.serve.engine import RetrievalEngine  # noqa: F401
from repro_torch.serve.index import (ExactIndex, GalleryIndex,  # noqa: F401
                                     MetricIndex)
from repro_torch.serve.ivf import IVFIndex, kmeans_projected  # noqa: F401
from repro_torch.serve.mutable import MutableIndex  # noqa: F401
from repro_torch.serve.pq import IVFPQIndex, ProductQuantizer  # noqa: F401
from repro_torch.serve.scan import recall_at_k  # noqa: F401
from repro_torch.serve.snapshot import (has_snapshot,  # noqa: F401
                                        l_fingerprint, load_index,
                                        save_index)
