"""Metric-space retrieval serving: index -> engine -> micro-batcher.

Counterpart of ``repro/serve`` for the single-device paths: the
``MetricIndex`` protocol and ``ExactIndex`` (index.py), the approximate
backends ``IVFIndex`` (ivf.py) and ``IVFPQIndex`` with its
``ProductQuantizer`` (pq.py), all over the shared projection/selection
substrate (scan.py), the mutation lifecycle layer (mutable.py
``MutableIndex``: upserts, deletes, compaction, metric hot-swap;
snapshot.py: save / load without re-projection, in the reference's
format), a bucketed engine with a hot-query LRU (engine.py), two front
doors — the request-coalescing micro-batcher (batcher.py) and the
traffic-shaped scheduler above it (scheduler.py: bounded admission,
priority / deadline classes, adaptive degradation) — and the
multi-tenant router (tenant.py: N metrics over one shared raw store on
the card, shadow arms, tenant snapshots), all timing on the injectable
clock (clock.py). The device paths are kernels/metric_topk,
kernels/ivf_scan and kernels/pq_adc.
"""

from repro_torch.serve.batcher import MicroBatcher  # noqa: F401
from repro_torch.serve.clock import (Clock, FakeClock,  # noqa: F401
                                     SystemClock)
from repro_torch.serve.engine import RetrievalEngine  # noqa: F401
from repro_torch.serve.scheduler import (DEFAULT_CLASSES,  # noqa: F401
                                         DeadlineExceededError,
                                         DegradeTransition, LatencyWindow,
                                         LoadController, PriorityClass,
                                         RejectedError, RequestScheduler,
                                         SchedulerError, default_ladder)
from repro_torch.serve.index import (ExactIndex, GalleryIndex,  # noqa: F401
                                     MetricIndex)
from repro_torch.serve.ivf import IVFIndex, kmeans_projected  # noqa: F401
from repro_torch.serve.mutable import MutableIndex  # noqa: F401
from repro_torch.serve.pq import IVFPQIndex, ProductQuantizer  # noqa: F401
from repro_torch.serve.scan import recall_at_k  # noqa: F401
from repro_torch.serve.snapshot import (has_snapshot,  # noqa: F401
                                        l_fingerprint, load_index,
                                        save_index)
from repro_torch.serve.tenant import (ShadowArm, Tenant,  # noqa: F401
                                      TenantError, TenantFingerprintError,
                                      TenantRouter, attach_view,
                                      load_tenants, save_tenants)
