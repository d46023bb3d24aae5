"""Single-query requests in an open loop with Poisson arrivals at a fixed
rate, through the front door ``serve/batcher.MicroBatcher``.

Independent users: each request is one query (k nearest rows), sent when
it is due whether or not earlier ones are answered. A request is timed
from when it was due to when its answer came back (the future's done
callback), so a stall of the sender counts against every request it
delays. Every seed offers the same arrival gaps in another order and
cycles through the same query pool, each query once a ``query_pool``
requests: more than the engine's result cache holds, so the cache can
hit nothing.

Set-up ends with ``warm_s`` seconds of the same open loop, unmeasured:
a loop's first seconds read a higher tail than the rest, and the window
goes on from there in the pool's cycle, so the cache still hits nothing.
"""

from __future__ import annotations

import functools
import math
import sys
import threading
import time

import numpy as np

from repro_torch.serve import MicroBatcher

from bench.harness import data
from bench.harness.drivers._search import SearchDriver
from bench.harness.profile import Section

WAIT_PAST_CLOSE_S = 60.0


def nearest_rank(values: np.ndarray, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q% of the values at or below it."""
    v = np.sort(values)
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def tail_line(lat, sent, due, stretch_s: float = 5.0) -> str:
    """Where the tail comes from: p95 from the send, without the sender's
    lateness, and p95 by stretches of ``stretch_s`` of due times."""
    fin = np.isfinite(lat)
    inside = np.where(fin, lat - (sent - due), np.inf)
    parts = []
    for a in np.arange(0.0, due[-1], stretch_s):
        sel = (due >= a) & (due < a + stretch_s)
        if sel.sum():
            parts.append(f"{1e3 * nearest_rank(lat[sel], 95):.3f}")
    return (f"p95 from the send {1e3 * nearest_rank(inside, 95):.4f} ms; "
            f"p95 by {stretch_s:g} s stretches [{', '.join(parts)}] ms")


class Driver(SearchDriver):

    sent = 0        # requests of the loop so far: the pool's cycle goes on

    def build(self):
        super().build()
        tr = self.traffic
        self.front = MicroBatcher(self.engine, max_batch=int(tr["max_batch"]),
                                  max_wait_ms=float(tr["max_wait_ms"]))

    def warm(self):
        self.warm_shapes(range(1, int(self.traffic["max_batch"]) + 1))
        futs = [self.front.submit(q) for q in self.warm_queries(
            int(self.traffic["warm_requests"]))]
        for f in futs:
            f.result(timeout=WAIT_PAST_CLOSE_S)
        warm_s = float(self.traffic["warm_s"])
        if warm_s > 0:
            self.loop(warm_s, trace=False, log=False)

    def window(self, seconds: float, trace: bool) -> dict:
        return self.loop(seconds, trace, log=True)

    def loop(self, seconds: float, trace: bool, log: bool) -> dict:
        tr, k = self.traffic, self.k
        rate = float(tr["rate"])
        n = max(1, int(round(rate * seconds)))
        due = np.cumsum(data.exponential_gaps(self.seed, n, rate))
        n_pool = len(self.queries)
        rows = (self.sent + np.arange(n)) % n_pool
        self.sent += n
        t_sub = np.zeros(n)
        t_done = np.full(n, np.nan)
        dists = np.zeros((n, k), np.float32)
        ids = np.full((n, k), -1, np.int64)
        ok = np.zeros(n, bool)
        finished = threading.Event()
        count = [0]
        lock = threading.Lock()

        def done(i, fut):
            t_done[i] = time.perf_counter()
            if fut.exception() is None:
                dists[i], ids[i] = fut.result()
                ok[i] = True
            with lock:
                count[0] += 1
                if count[0] == n:
                    finished.set()

        section = Section(self.device) if trace else None
        t_on = float(tr["trace_from_s"])
        t_span = float(tr["trace_s"])
        batches0 = self.front.n_batches
        queries0 = self.engine.n_queries
        hits0 = self.engine.cache_hits
        t0 = time.perf_counter() + 0.01
        for i in range(n):
            if section is not None:
                now = time.perf_counter()
                if section.prof is None and now - t0 >= t_on:
                    self.trace_on(section)
                elif section.running and now - section.t0 >= t_span:
                    self.trace_off(section)
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t_sub[i] = time.perf_counter()
            try:
                fut = self.front.submit(self.queries[rows[i]])
            except Exception as e:      # a refused request: no answer
                print(f"request {i} refused: {e!r}", file=sys.stderr)
                done(i, _Failed())
                continue
            fut.add_done_callback(functools.partial(done, i))
        t_close = t0 + due[-1]
        finished.wait(timeout=max(0.0, t_close + WAIT_PAST_CLOSE_S
                                  - time.perf_counter()))
        if section is not None and section.running:
            self.trace_off(section)
        lat = np.where(ok & ~np.isnan(t_done), t_done - (t0 + due), np.inf)
        late = t_sub - (t0 + due)
        if log:
            print(f"open loop: {n} requests at {rate:g}/s over "
                  f"{due[-1]:.3f} s; sender late p50 "
                  f"{1e3 * np.median(late):.4f} ms, p99 "
                  f"{1e3 * nearest_rank(late, 99):.4f} ms, max "
                  f"{1e3 * late.max():.4f} ms; result-cache hits "
                  f"{self.engine.cache_hits - hits0}", file=sys.stderr)
            print(tail_line(lat, t_sub - t0, due), file=sys.stderr)
            n_b = self.front.n_batches - batches0
            sizes = np.array(list(self.front.batch_sizes)[-n_b:] or [0])
            fin = lat[np.isfinite(lat)]
            print(f"latency p50 {1e3 * np.median(fin):.4f} ms, mean "
                  f"{1e3 * fin.mean():.4f} ms; last {len(sizes)} batches: "
                  f"mean {sizes.mean():.2f}, p99 "
                  f"{nearest_rank(sizes, 99):g}, max {sizes.max()}, over "
                  f"32 {100 * np.mean(sizes > 32):.3f}%", file=sys.stderr)
        answered = int(ok.sum())
        last = float(np.nanmax(t_done)) if answered else t_close
        out = {"seconds": last - t0, "attempted": n,
               "failed": n - answered, "answered": answered,
               "latency_s": lat, "rows": rows,
               "t_due": t0 + due, "t_done": t_done,
               "dists": dists, "ids": ids, "ok": ok,
               "batches": self.front.n_batches - batches0,
               "requests": self.engine.n_queries - queries0,
               "section": section, "traced_s": 0.0, "answered_traced": 0}
        if section is not None and section.t_end is not None:
            out["traced_s"] = section.span_s
            out["answered_traced"] = int(np.sum(
                ok & (t_done >= section.t_begin) & (t_done <= section.t_end)))
            out["engine_spans"] = self.engine_spans()
            out["topk_rows"] = self.traced_rows(section)
            out["ranges"] = {"bench.topk": self.timer.read()}
        return out

    def end_to_end(self, win: dict) -> dict:
        return {"search_p95_ms": 1e3 * nearest_rank(win["latency_s"], 95)}

    def check(self, win: dict) -> dict:
        answered = np.nonzero(win["ok"])[0]
        pick = answered[self.sample(len(answered))]
        self.free_program()
        self.checked = (win["rows"][pick], win["dists"][pick],
                        win["ids"][pick])
        out = self.judge_answers(*self.checked)
        out["lost"] = win["attempted"] - win["answered"]
        return out

    def close(self):
        front = self.__dict__.pop("front", None)
        if front is not None and not front.close():
            raise RuntimeError("the batcher's worker did not stop")


class _Failed:
    """Stands for the future of a request the front door refused."""

    def exception(self):
        return RuntimeError("refused")
