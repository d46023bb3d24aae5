"""The readings that a cell's limits are set from, on the chip at the
cell's own size (the benchmark's runs do not run this):

  * the program, sound, over many seeds: the lower readings;
  * the control, the plain reference in float32 with TF32 products (one
    step below the configurations' float32) in the program's place, on
    the same inputs;
  * each fault of ``faults.py`` planted under the timed path.

    python3 bench/tools/readings.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 [--seconds 2] [--out FILE]

Every reading is one JSON line on standard output (and in ``--out``).
A search cell's program runs drive a short window at the cell's load,
long enough to answer as many queries as its check compares.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench.harness import judge, registry  # noqa: E402
from bench.harness.drivers import train_ps  # noqa: E402
from bench.harness.registry import Benchmark  # noqa: E402
from bench.tools.faults import FAULTS  # noqa: E402

FIRST_SEED = 2_100_000_000


def one(cell, seed: int, seconds: float, device, fault=None,
        control=False) -> dict:
    """The check's numbers of one run (and of the control on its inputs,
    when asked)."""
    drv = registry.driver_module(cell.driver).Driver(
        cell.config, cell.traffic, seed, device)
    if fault is not None:
        drv.hooks.append(FAULTS[cell.driver][fault])
    t = time.perf_counter()
    try:
        drv.build()
        drv.warm()
        win = drv.window(seconds, trace=False)
        out = {"program": drv.check(win)}
        if control and cell.driver == "train_ps":
            low = train_ps.as_program_output(drv.reference("tf32"), drv.P)
            out["control"] = judge.train_numbers(low, drv.ref64, drv.L0,
                                                 drv.lr1())
        elif control:
            rows, _, _ = drv.checked
            d, i = drv.control_answers(rows, "tf32")
            out["control"] = drv.judge_answers(rows, d, i)
    finally:
        drv.close()
    out["seconds"] = time.perf_counter() - t
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = Benchmark(ROOT, held=True).cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for n, seed in enumerate(seeds):
        out = one(cell, seed, args.seconds, device,
                  control=n < args.control_seeds)
        emit({"cell": cell.name, "seed": seed, "kind": "program",
              **out["program"], "seconds": out["seconds"]})
        if "control" in out:
            emit({"cell": cell.name, "seed": seed, "kind": "control",
                  **out["control"]})
    for fault in FAULTS[cell.driver]:
        for seed in seeds[:args.fault_seeds]:
            out = one(cell, seed, args.seconds, device, fault=fault)
            emit({"cell": cell.name, "seed": seed, "kind": fault,
                  **out["program"], "seconds": out["seconds"]})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
