"""One run of one cell: set-up, the measured window, the metrics, the
check, and the result line.

Set-up is timed from the process's start (the caller's ``t_start``) to
the window's start, so building the kernels, making the data and
warming every shape the window uses all count in ``setup_s``. Before the
window the heap is collected in full; the collections inside the window
are counted and printed. After the window the device's
peak memory is read, the program is freed, and the reference judges
what the window's timed path produced.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import types

import torch

from bench.harness import device as card
from bench.harness import judge, profile, registry


class _Collections:
    """Counts the collector's runs and pauses while it is installed."""

    def __init__(self):
        self.by_gen = [0, 0, 0]
        self.pauses = []
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.by_gen[info["generation"]] += 1
            self.pauses.append(time.perf_counter() - self._t)

    def line(self) -> str:
        p = self.pauses
        return (f"collections in the window by generation {self.by_gen}, "
                f"paused {1e3 * sum(p):.3f} ms in all, longest "
                f"{1e3 * max(p, default=0.0):.3f} ms")


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool,
        device, t_start: float, hooks=(), log=sys.stderr) -> dict:
    """The result line's object for one run of ``cell``."""
    drv = registry.driver_module(cell.driver).Driver(
        cell.config, cell.traffic, seed, device)
    drv.hooks.extend(hooks)
    dev = drv.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        drv.build()
        drv.warm()
        if trace and dev.type == "cuda":
            profile.warm_profiler(dev)
        card.sync(dev)
        gc.collect()
        setup_s = time.perf_counter() - t_start
        colls = _Collections()
        gc.callbacks.append(colls)
        try:
            win = drv.window(seconds, trace)
        finally:
            gc.callbacks.remove(colls)
        print(colls.line(), file=log)
        block = card.describe(dev, cell.chips)
        metrics, reduced = {}, None
        if not trace:
            values = dict(drv.end_to_end(win), setup_s=setup_s)
            metrics = {m.name: {"value": values[m.name], "unit": m.unit}
                       for m in cell.end_to_end}
        else:
            section = win.get("section")
            ranges = win.get("ranges") or {}
            if section is not None and section.t_end is not None:
                reduced = section.reduce(
                    {n: r["intervals"] for n, r in ranges.items()})
            ctx = types.SimpleNamespace(
                cell=cell.name, config=cell.config, traffic=cell.traffic,
                window=win, trace=reduced, peak=card.peaks(block["kind"]))
            for m in cell.per_layer:
                value = cell.readers[m.name](ctx)
                if value is not None:
                    metrics[m.name] = {"value": value, "unit": m.unit}
            if reduced is not None:
                block["busy_s"] = reduced["busy_s"]
                block["window_s"] = reduced["window_s"]
                print(f"traced {reduced['window_s']:.6f} s of the window",
                      file=log)
                for name, r in reduced["ranges"].items():
                    print(f"range {name}: {r['calls']} calls, "
                          f"{r['launches']} launches, device "
                          f"{r['device_s']:.6f} s by the trace, "
                          f"{ranges[name]['event_s']:.6f} s between its "
                          f"CUDA events", file=log)
            if dev.type == "cuda":
                print(f"card {block['kind']}, power limit "
                      f"{card.power_limit()}", file=log)
        numbers = drv.check(win)
    finally:
        drv.close()
    numbers["failed"] = win["failed"]
    limits = dict(cell.limits, failed=0)
    correct, checks = judge.judge(numbers, limits)
    for name, value in sorted(numbers.items()):
        if name not in limits:
            print(f"read (no limit): {name} {value!r}", file=log)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=log)
    out = {"correct": correct, "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": block}
    if reduced is not None:
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out
