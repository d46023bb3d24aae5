"""One client in a closed loop, each request ``batch`` queries straight to
``RetrievalEngine.search``: the front door is bypassed.

Offline kNN labelling or de-duplication of a corpus in chunks. One
client, because the engine is called from one thread by its contract.
The requests walk the query pool in an order drawn from the seed, each
query once a ``query_pool`` queries. The mix states the engine's result
cache's size: a job over a corpus, which repeats no query, runs it off.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from bench.harness.drivers._search import SearchDriver
from bench.harness.profile import Section


class Driver(SearchDriver):

    def warm(self):
        bs = int(self.traffic["batch"])
        self.warm_shapes([bs])
        warm = self.warm_queries(bs * int(self.traffic["warm_requests"]))
        for j in range(int(self.traffic["warm_requests"])):
            self.engine.search(warm[j * bs:(j + 1) * bs])

    def window(self, seconds: float, trace: bool) -> dict:
        tr = self.traffic
        bs = int(tr["batch"])
        per_cycle = len(self.queries) // bs
        section = Section(self.device) if trace else None
        t_on = float(tr["trace_from_s"])
        t_span = float(tr["trace_s"])
        answers, failed, j = [], 0, 0
        hits0 = self.engine.cache_hits
        t0 = now = time.perf_counter()
        while now - t0 < seconds:
            if section is not None:
                if section.prof is None and now - t0 >= t_on:
                    self.trace_on(section)
                elif section.running and now - section.t0 >= t_span:
                    self.trace_off(section)
            c = (j % per_cycle) * bs
            q = self.queries[c:c + bs]
            try:
                if self.tracing:
                    tracer = self.engine.tracer
                    t = tracer.start_trace("request")
                    d, i = self.engine.search(q, span=t.root)
                    tracer.finish(t)
                else:
                    d, i = self.engine.search(q)
            except Exception as e:      # a failed request: no answers
                print(f"request {j} failed: {e!r}", file=sys.stderr)
                failed += 1
                d = i = None
            answers.append((c, d, i, time.perf_counter()))
            j += 1
            now = time.perf_counter()
        if section is not None and section.running:
            self.trace_off(section)
        print(f"closed loop: {j} requests of {bs} queries in {now - t0:.3f}"
              f" s; result-cache hits {self.engine.cache_hits - hits0}",
              file=sys.stderr)
        done = [(c, d, i, t) for c, d, i, t in answers if d is not None]
        out = {"seconds": now - t0, "attempted": j, "failed": failed,
               "answered": bs * len(done), "answers": done,
               "section": section, "traced_s": 0.0, "answered_traced": 0}
        if section is not None and section.t_end is not None:
            out["traced_s"] = section.span_s
            out["answered_traced"] = bs * sum(
                section.t_begin <= t <= section.t_end for *_, t in done)
            out["engine_spans"] = self.engine_spans()
            out["topk_rows"] = self.traced_rows(section)
            out["ranges"] = {"bench.topk": self.timer.read()}
        return out

    def end_to_end(self, win: dict) -> dict:
        return {"search_qps": win["answered"] / win["seconds"]}

    def check(self, win: dict) -> dict:
        bs = int(self.traffic["batch"])
        done = win["answers"]
        pick = self.sample(bs * len(done))
        req, row = pick // bs, pick % bs
        rows = np.array([done[r][0] for r in req], np.int64) + row
        dists = np.array([done[r][1][w] for r, w in zip(req, row)],
                         np.float32).reshape(-1, self.k)
        ids = np.array([done[r][2][w] for r, w in zip(req, row)],
                       np.int64).reshape(-1, self.k)
        self.free_program()
        self.checked = (rows, dists, ids)
        out = self.judge_answers(rows, dists, ids)
        out["lost"] = bs * win["failed"]
        return out
