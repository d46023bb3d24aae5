"""The traced stretch of a window and its reduction to numbers.

``Section`` runs ``torch.profiler`` over a stretch of the window that a
driver starts and stops, inside a ``bench.traced`` range. ``reduce``
reads the profiler's chrome trace (written to a temporary file under
``TMPDIR`` and deleted) and gives:

  * ``busy_s`` and ``window_s``: the union of the device's kernel, copy
    and set intervals inside the traced range, and the range's length;
  * ``device_ops``: device seconds by operation name, largest first;
  * ``idle_gaps``: the device's idle seconds inside the range, by the
    innermost host operation running in the middle of each gap;
  * ``ranges``: for each ``RangeTimer`` range, its calls and the device
    seconds of the kernels and copies they launched (matched by the
    trace's correlation ids), so that a share of a roofline is taken over
    device time alone and not over the host's gaps between launches.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

TRACED = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
IDLE_HOST = "host outside any profiled operation"
TOP = 10


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once over a small operation, so that
    its first start (the CUDA tracer's set-up, seconds) falls in set-up
    and not in the window."""
    s = Section(device)
    s.start()
    torch.ones(8, device=device).sum()
    s.stop()
    s.prof = None


class RangeTimer:
    """The calls of a wrapped function while ``on``, from any thread: each
    call's host interval on ``time.perf_counter``, which ``reduce_events``
    maps onto the trace to sum the device time of what the call launched
    (the profiler records ``record_function`` ranges only on the thread
    that started it, so a range on a server's worker thread is not in
    the trace). CUDA events at each call's ends give a second reading,
    which holds the device's idle gaps inside the call too."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on = False
        self.intervals = []
        self.events = []

    def wrap(self, fn, name: str):
        from torch.profiler import record_function

        def timed(*args, **kw):
            if not self.on:
                with record_function(name):
                    return fn(*args, **kw)
            cuda = self.device.type == "cuda"
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            with record_function(name):
                out = fn(*args, **kw)
            t1 = time.perf_counter()
            if cuda:
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                self.events.append((a, b))
            self.intervals.append((t0, t1))
            return out

        return timed

    def read(self) -> dict:
        """The host intervals of the calls timed so far, and the seconds
        between their CUDA events."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        secs = sum(a.elapsed_time(b) for a, b in self.events) / 1e3
        return {"intervals": list(self.intervals), "event_s": secs}


class Section:
    """One profiled stretch: ``start()``, ``stop()``, then ``reduce()``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t_begin = self.t0 = self.t1 = self.t_end = None
        self.h0 = self.h1 = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self.t_begin = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._range = record_function(TRACED)
        h = time.perf_counter()
        self._range.__enter__()
        self.t0 = time.perf_counter()
        self.h0 = 0.5 * (h + self.t0)

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self._range.__exit__(None, None, None)
        self.h1 = 0.5 * (self.t1 + time.perf_counter())
        self.prof.stop()
        self.t_end = time.perf_counter()

    @property
    def span_s(self) -> float:
        """Host seconds from before the profiler's start to after its
        stop: the stretch that the window's rates leave out."""
        return self.t_end - self.t_begin

    def reduce(self, ranges=None) -> dict:
        """The trace's numbers; ``ranges`` maps a name to the host
        intervals (``time.perf_counter``) of a ``RangeTimer``'s calls."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_events(events, ranges, (self.h0, self.h1))


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def short_name(name: str) -> str:
    """A kernel's function name without its namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_][\w:]*(?:<[^()]*>)?)\(", name)
    out = m.group(1) if m else name
    return out.split("::")[-1][:96] if "<" not in out else out[:96]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _HostTree:
    """Host operations of one thread, nested, for 'innermost at t'."""

    def __init__(self, events):
        events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.top, stack = [], []
        for e in events:
            node = (float(e["ts"]), float(e["ts"]) + e["dur"], e["name"], [])
            while stack and stack[-1][1] <= node[0]:
                stack.pop()
            (stack[-1][3] if stack else self.top).append(node)
            stack.append(node)
        self._starts = {}

    def _level_starts(self, level):
        key = id(level)
        if key not in self._starts:
            self._starts[key] = [n[0] for n in level]
        return self._starts[key]

    def innermost(self, t):
        level, found = self.top, None
        while level:
            i = bisect.bisect_right(self._level_starts(level), t) - 1
            if i < 0 or level[i][1] <= t:
                break
            found = level[i]
            level = found[3]
        return found


def range_device_seconds(xs, intervals) -> dict:
    """Device seconds of what the calls launched: the device events whose
    correlation id is that of a CUDA runtime or driver call made inside
    one of ``intervals`` (trace microseconds). The benchmark's ranges are
    the only launches in their intervals: the other thread of a cell
    (the open loop's sender) launches nothing."""
    calls = sorted((float(e["ts"]), (e.get("args") or {}).get("correlation"))
                   for e in xs if _cat(e) in LAUNCH_CATS)
    starts = [t for t, _ in calls]
    dur = defaultdict(float)
    for e in xs:
        corr = (e.get("args") or {}).get("correlation")
        if _cat(e) in DEVICE_CATS and corr is not None:
            dur[corr] += float(e["dur"])
    total, launches = 0.0, 0
    for a, b in intervals:
        for _, corr in calls[bisect.bisect_left(starts, a):
                             bisect.bisect_right(starts, b)]:
            if corr in dur:
                total += dur.pop(corr)
                launches += 1
    return {"calls": len(intervals), "device_s": total / 1e6,
            "launches": launches}


def reduce_events(events, ranges=None, clock=None) -> dict:
    """The numbers of a trace whose traced range's ends were entered at
    host times ``clock`` (``time.perf_counter``), which maps the host
    intervals of ``ranges`` ({name: [(t0, t1), ...]}) onto it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if _cat(e) == "user_annotation"
           and e.get("name") == TRACED]
    if not win:
        raise ValueError(f"the trace holds no {TRACED!r} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if _cat(e) in DEVICE_CATS]
    inside = [(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + e["dur"]))
              for e in dev]
    inside = [(a, b) for a, b in inside if b > a]
    merged = _union(inside)
    busy_us = sum(b - a for a, b in merged)

    by_op = defaultdict(float)
    for e in dev:
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + e["dur"])
        if b > a:
            by_op[short_name(e["name"])] += (b - a) / 1e6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

    trees = defaultdict(list)
    for e in xs:
        if _cat(e) in HOST_CATS and e.get("name") != TRACED:
            trees[e.get("tid")].append(e)
    trees = [_HostTree(v) for v in trees.values()]
    gaps, last = [], w0
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        found = [n for n in (t.innermost(mid) for t in trees) if n]
        name = min(found, key=lambda n: n[1] - n[0])[2] if found \
            else IDLE_HOST
        by_host[name] += (b - a) / 1e6
    idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    out = {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
           "device_ops": [[k, v] for k, v in device_ops],
           "idle_gaps": [[k, v] for k, v in idle_gaps], "ranges": {}}
    if ranges and clock is not None:
        h0, h1 = clock
        scale = (w1 - w0) / (h1 - h0)
        for name, intervals in ranges.items():
            out["ranges"][name] = range_device_seconds(
                xs, [(w0 + (a - h0) * scale, w0 + (b - h0) * scale)
                     for a, b in intervals])
    return out
