"""The knee of an open-loop search cell: the highest offered rate at which
the completed rate keeps up with the offered one and the backlog does
not grow from the window's first half to its second. One set-up, then
one window a rate, in the order given (on the chip; the benchmark's
runs do not run this):

    python3 bench/tools/sweep.py --workload imnet1m.search.open \\
        --rates 500,1000,1500,2000 [--seconds 8] [--seed N]

Prints one JSON line a rate.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench.harness import registry  # noqa: E402
from bench.harness.drivers.search_open import nearest_rank  # noqa: E402
from bench.harness.registry import Benchmark  # noqa: E402


def backlog(t_due, t_done, t) -> int:
    """Requests due by t and not answered by t."""
    return int(np.sum(t_due <= t) - np.sum(t_done <= t))


def summary(rate: float, win: dict) -> dict:
    t_due, t_done = win["t_due"], win["t_done"]
    t0, t_end = t_due[0], t_due[-1]
    done = t_done[~np.isnan(t_done)]
    lat = win["latency_s"]
    half = len(lat) // 2
    return {"rate": rate, "offered_per_s": len(t_due) / (t_end - t0),
            "completed_per_s": len(done) / (done.max() - t0),
            "backlog_mid": backlog(t_due, t_done, 0.5 * (t0 + t_end)),
            "backlog_end": backlog(t_due, t_done, t_end),
            "p50_ms_first_half": 1e3 * float(np.median(lat[:half])),
            "p50_ms_second_half": 1e3 * float(np.median(lat[half:])),
            "p95_ms": 1e3 * nearest_rank(lat, 95),
            "p99_ms": 1e3 * nearest_rank(lat, 99),
            "batch_mean": win["requests"] / max(1, win["batches"]),
            "failed": win["failed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=2_050_000_003)
    args = ap.parse_args(argv)
    cell = Benchmark(ROOT, held=True).cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    drv = registry.driver_module(cell.driver).Driver(
        cell.config, cell.traffic, args.seed, device)
    try:
        drv.build()
        drv.warm()
        for rate in (float(r) for r in args.rates.split(",")):
            drv.traffic = dict(cell.traffic, rate=rate)
            gc.collect()
            win = drv.window(args.seconds, trace=False)
            print(json.dumps(summary(rate, win)), flush=True)
    finally:
        drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
