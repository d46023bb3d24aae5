"""Text dashboard over a MetricsRegistry snapshot file.

Run:  PYTHONPATH=src python -m repro_torch.launch.metrics_report \
          metrics.json [--merge more.json ...] [--events 8]

Counterpart of ``repro.launch.metrics_report``; the snapshot format is
the same in both packages, so each renders the other's files.

Renders the snapshot a serving run exported with
``serve_retrieval --metrics-out metrics.json`` (or any
``MetricsRegistry.write_snapshot`` output) as a terminal dashboard:
serving traffic counters, per-class latency percentiles (estimated from
the ``frontend_latency_seconds`` histogram buckets), queue depths and
the degradation-ladder level, engine cache behavior, per-index memory
gauges, and the most recent lifecycle events. ``--merge`` folds
additional snapshot files in first (counters/histograms add, gauges
take the later file's value) — the per-worker roll-up path.

The miner's ``miner_pairs_total`` (``serve_retrieval --mine``) and the
``loop_*`` gauges of a registry a ``ClosedLoopTrainer`` recorded into
render under "closed loop". docs/observability.md is the catalog of
every metric name rendered here.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.obs.metrics import merge_snapshots, parse_label_key


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _hist_percentile(hist: dict, key: str, q: float) -> float:
    """Upper-bound percentile estimate from one histogram cell (same
    rule as obs.Histogram.percentile): the bound of the bucket holding
    the q-th sample; inf in the overflow bucket, NaN when empty."""
    cell = hist["values"].get(key)
    if cell is None or cell["count"] == 0:
        return float("nan")
    rank = q / 100.0 * cell["count"]
    run = 0
    bounds = list(hist["buckets"]) + [float("inf")]
    for bound, c in zip(bounds, cell["counts"]):
        run += c
        if run >= rank and c:
            return bound
    return float("inf")


def _counter_values(snap: dict, name: str) -> dict:
    return snap.get("counters", {}).get(name, {}).get("values", {})


def _gauge_values(snap: dict, name: str) -> dict:
    return snap.get("gauges", {}).get(name, {}).get("values", {})


def render(snap: dict, n_events: int = 8) -> str:
    """The dashboard text for one (possibly merged) snapshot dict."""
    lines = []
    w = lines.append

    w("== serving ==")
    eng = {k: v.get("", 0.0) for k, v in
           ((n, _counter_values(snap, f"engine_{n}_total"))
            for n in ("requests", "queries", "device_queries",
                      "busy_seconds", "cache_hits", "cache_misses"))}
    dev, busy = eng["device_queries"], eng["busy_seconds"]
    qps = dev / busy if busy > 0 else 0.0
    w(f"engine: {eng['requests']:.0f} requests / {eng['queries']:.0f} "
      f"queries ({dev:.0f} on device, {busy:.3f}s busy, {qps:.0f} qps)")
    looked = eng["cache_hits"] + eng["cache_misses"]
    rate = eng["cache_hits"] / looked if looked else 0.0
    entries = _gauge_values(snap, "engine_cache_entries").get("", 0.0)
    w(f"cache:  {eng['cache_hits']:.0f} hits / "
      f"{eng['cache_misses']:.0f} misses ({rate:.1%} hit rate, "
      f"{entries:.0f} entries resident)")
    for name in ("batcher_batches_total", "frontend_batches_total"):
        vals = _counter_values(snap, name)
        if vals:
            w(f"{name.split('_')[0]}: {vals.get('', 0.0):.0f} batches")

    depths = _gauge_values(snap, "frontend_queue_depth")
    level = _gauge_values(snap, "frontend_degradation_level").get("")
    if depths or level is not None:
        w("")
        w("== front end ==")
        if depths:
            parts = [f"{parse_label_key(k).get('cls', '?')}="
                     f"{v:.0f}" for k, v in sorted(depths.items())]
            w(f"queue depth: {' '.join(parts)} "
              f"(total {sum(depths.values()):.0f})")
        if level is not None:
            w(f"ladder level: {level:.0f} (0 = full quality)")
        reqs = _counter_values(snap, "frontend_requests_total")
        per_class: dict = {}
        for key, v in reqs.items():
            lab = parse_label_key(key)
            per_class.setdefault(lab.get("cls", "?"), {})[
                lab.get("outcome", "?")] = v
        lat = snap.get("histograms", {}).get("frontend_latency_seconds")
        for cls in sorted(per_class):
            c = per_class[cls]
            row = (f"  {cls:<12} admitted {c.get('admitted', 0):.0f} "
                   f"completed {c.get('completed', 0):.0f} "
                   f"expired {c.get('expired', 0):.0f} "
                   f"rejected {c.get('rejected', 0):.0f}")
            if lat is not None:
                p50 = _hist_percentile(lat, f"cls={cls}", 50.0)
                p99 = _hist_percentile(lat, f"cls={cls}", 99.0)
                row += (f"  p50<={p50 * 1e3:.1f}ms p99<={p99 * 1e3:.1f}ms")
            w(row)

    mem = _gauge_values(snap, "index_memory_bytes")
    if mem:
        w("")
        w("== index memory ==")
        rows = _gauge_values(snap, "index_gallery_rows").get("", 0.0)
        w(f"gallery rows: {rows:.0f}")
        total = 0.0
        for key, v in sorted(mem.items()):
            comp = parse_label_key(key).get("component", key)
            total += v
            if v:
                w(f"  {comp:<12} {_fmt_bytes(v)}")
        w(f"  {'total':<12} {_fmt_bytes(total)}")

    loop_gauges = {n: _gauge_values(snap, f"loop_{n}").get("")
                   for n in ("staleness_steps", "mined_frac", "pool_size",
                             "neg_yield", "pos_yield")}
    if any(v is not None for v in loop_gauges.values()):
        w("")
        w("== closed loop ==")
        refreshes = _counter_values(
            snap, "loop_refreshes_total").get("", 0.0)
        w(f"refreshes: {refreshes:.0f}")
        for n, v in loop_gauges.items():
            if v is not None:
                w(f"  {n:<16} {v:g}")
        mined = _counter_values(snap, "miner_pairs_total")
        if mined:
            parts = [f"{parse_label_key(k).get('kind', '?')}={v:.0f}"
                     for k, v in sorted(mined.items())]
            w(f"  mined pairs: {' '.join(parts)}")

    events = snap.get("events", [])
    if events:
        w("")
        w(f"== events (last {min(n_events, len(events))} of "
          f"{len(events)}) ==")
        for e in events[-n_events:]:
            attrs = {k: v for k, v in e.items()
                     if k not in ("t", "event")}
            w(f"  t={e.get('t', 0.0):.3f} {e.get('event', '?'):<22} "
              + " ".join(f"{k}={v}" for k, v in attrs.items()))
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshot", help="MetricsRegistry snapshot JSON "
                                     "(serve_retrieval --metrics-out)")
    ap.add_argument("--merge", nargs="*", default=[],
                    help="additional snapshot files to merge in "
                         "(counters/histograms add, later gauges win)")
    ap.add_argument("--events", type=int, default=8,
                    help="recent lifecycle events to show")
    args = ap.parse_args(argv)
    with open(args.snapshot) as f:
        snap = json.load(f)
    for path in args.merge:
        with open(path) as f:
            snap = merge_snapshots(snap, json.load(f))
    print(render(snap, n_events=args.events), end="")


if __name__ == "__main__":
    main()
