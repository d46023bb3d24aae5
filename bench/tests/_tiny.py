"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
the same drivers, traffic and limits, narrow widths and few rows."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness.registry import Benchmark  # noqa: E402

# wide enough that f32 rounding reads against the norms about as it does
# at the cells' sizes, so the cells' own limits hold
TRAIN = {"feat_dim": 2048, "proj_dim": 128, "batch_size": 128,
         "train_rows": 3000, "n_classes": 20, "n_similar": 6000,
         "n_dissimilar": 6000}
SEARCH = {"feat_dim": 256, "proj_dim": 32, "n_samples": 40000,
          "n_classes": 20}
TRAFFIC = {"train_ps": {"trace_from_step": 20, "trace_steps": 20},
           "search_open": {"rate": 100, "max_wait_ms": 20.0,
                           "query_pool": 2048, "check_answers": 256,
                           "warm_requests": 16, "warm_s": 0.2,
                           "trace_from_s": 0.3, "trace_s": 0.4},
           "search_closed": {"query_pool": 2048, "check_answers": 256,
                             "trace_from_s": 0.3, "trace_s": 0.4}}


def bench() -> Benchmark:
    """``BENCHMARK.json`` with the cells held out of it (``bench/held``)."""
    return Benchmark(ROOT, held=True)


def tiny(cell):
    """``cell`` at the CPU's size."""
    sizes = TRAIN if cell.driver == "train_ps" else SEARCH
    return dataclasses.replace(
        cell, config=dict(cell.config, **sizes),
        traffic=dict(cell.traffic, **TRAFFIC[cell.driver]))
