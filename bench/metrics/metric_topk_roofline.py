"""The index's top-k call's share of its roofline (``serve/index.py``
``ExactIndex.topk`` over ``kernels/metric_topk``), in every search cell
that names it (``metric_topk_roofline.<cell kind>``).

The least time of a call of n query rows, counting the rows the request
needs and not the bucket's padding: n raw queries projected (2 n d_in
d_out FLOP) and scanned against M rows (2 n M d_out); reading the
queries, L, the projected gallery and its norms once and writing n k
(distance, id) pairs once. The mean over the profiled stretch's calls,
over the device time a call of the ``bench.topk`` range: the kernels and
copies that its calls launched, summed from the trace.
"""

from bench.harness.device import least_seconds


def call_work(cfg: dict, n: int, k: int):
    d, kk, M = cfg["feat_dim"], cfg["proj_dim"], cfg["n_samples"]
    ops = 2.0 * n * d * kk + 2.0 * n * M * kk
    nbytes = 4.0 * (n * d + kk * d + M * kk + M) + 8.0 * n * k
    return ops, nbytes


def read(run):
    if run.peak is None or run.trace is None:
        return None
    r = run.trace["ranges"].get("bench.topk")
    rows = run.window.get("topk_rows") or []
    if not r or not r["calls"] or r["device_s"] <= 0 or not rows:
        return None
    least = [least_seconds(*call_work(run.config, n, run.traffic["k"]),
                           run.peak) for n in rows]
    return 100.0 * (sum(least) / len(least)) / (r["device_s"] / r["calls"])
