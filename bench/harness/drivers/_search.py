"""Exact metric retrieval over a gallery projected at set-up: the set-up
and the check that the open-loop and closed-loop search mixes share.

Set-up makes the metric factor L and the gallery's raw rows from the
seed, block by block, and projects each block through the program's
``kernels/metric_topk.project_gallery`` into one index
(``serve/index.ExactIndex.from_projected``), served by
``serve/engine.RetrievalEngine`` with its defaults but the result
cache's size, which the mix states. The raw rows never
stay resident. The queries are ``query_pool`` distinct gallery rows plus
noise, kept on the host as a client holds them.

The check draws a sample of the window's answers from the seed, frees
the program, and judges each answer against the float64 reference,
which makes every gallery block again and projects it itself.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels.metric_topk import project_gallery
from repro_torch.serve import ExactIndex, RetrievalEngine

from bench.harness import data, judge
from bench.harness.device import sync as device_sync
from bench.harness.profile import RangeTimer
from bench.reference import knn

TOPK_RANGE = "bench.topk"


def bucket_of(buckets, n: int) -> int:
    """The engine's bucket for a batch of n rows (its documented rule:
    the smallest bucket that holds n, else n itself)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return n


class SearchDriver:

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.k = int(traffic["k"])
        self.project = project_gallery      # the program's projection
        self.hooks = []
        self.topk_calls = []                # (host time, rows) when traced
        self.tracing = False
        self.timer = RangeTimer(self.device)

    # -- set-up ---------------------------------------------------------

    def gallery_blocks(self):
        """(first row, raw rows) of the gallery, made from the seed."""
        for b, b0, b1 in data.blocks(self.cfg["n_samples"]):
            yield b0, data.rows(self.seed, "gallery", b, self.labels[b0:b1],
                                self.classes, self.cfg["noise"])

    def build(self):
        cfg, dev = self.cfg, self.device
        M, d_in, d_out = cfg["n_samples"], cfg["feat_dim"], cfg["proj_dim"]
        L = data.metric_factor(self.seed, d_out, d_in, dev)
        self.L = L.clone()                  # the reference's copy
        self.classes = data.make_classes(self.seed, cfg["n_classes"], d_in,
                                         cfg["sparsity"], dev)
        self.labels = data.make_labels(self.seed, "gallery", M,
                                       cfg["n_classes"], dev)
        n_pool = int(self.traffic["query_pool"])
        rows = np.random.RandomState(data.derive(self.seed, "query_rows")) \
            .choice(M, n_pool, replace=False)
        qrows = torch.as_tensor(rows, device=dev)
        gp = torch.empty((M, d_out), dtype=torch.float32, device=dev)
        gn = torch.empty((M,), dtype=torch.float32, device=dev)
        raw_q = torch.empty((n_pool, d_in), dtype=torch.float32, device=dev)
        for b0, x in self.gallery_blocks():
            b1 = b0 + len(x)
            gp[b0:b1], gn[b0:b1] = self.project(L, x)
            hit = (qrows >= b0) & (qrows < b1)
            raw_q[hit] = x[qrows[hit] - b0]
            del x
        self.index = ExactIndex.from_projected(L, gp, gn, device=dev)
        del gp, gn
        g = data.generator(dev, self.seed, "query_noise")
        queries = raw_q + self.cfg["query_noise"] * torch.randn(
            raw_q.shape, generator=g, device=dev)
        order = np.random.RandomState(data.derive(self.seed, "order")) \
            .permutation(n_pool)
        # the pool in the order it is sent, so that each request is a view
        self.queries = np.ascontiguousarray(queries.cpu().numpy()[order])
        del raw_q, queries
        self.engine = RetrievalEngine(
            self.index, k_top=self.k,
            cache_size=int(self.traffic["cache_size"]))
        self._instrument()
        for hook in self.hooks:
            hook(self)

    def _instrument(self):
        """A timed range around the index's top-k, and the rows that
        reached the device in each engine call while the window is
        traced (the engine's own counter)."""
        engine = self.engine
        search = engine.search
        def counted_search(queries, *args, **kw):
            if not self.tracing:
                return search(queries, *args, **kw)
            before, t = engine.n_device_queries, time.perf_counter()
            out = search(queries, *args, **kw)
            self.topk_calls.append((t, engine.n_device_queries - before))
            return out

        self.index.topk = self.timer.wrap(self.index.topk, TOPK_RANGE)
        engine.search = counted_search

    def warm_shapes(self, sizes):
        """One top-k of each engine bucket that batches of ``sizes`` rows
        reach, and nothing more."""
        d_in = self.cfg["feat_dim"]
        for b in sorted({bucket_of(self.engine.buckets, n) for n in sizes}):
            self.index.topk(torch.zeros((b, d_in), device=self.device),
                            self.k)
        device_sync(self.device)

    def warm_queries(self, n: int) -> np.ndarray:
        """Queries for warming the host path, none of them in the pool."""
        rng = np.random.RandomState(data.derive(self.seed, "warm"))
        return rng.standard_normal((n, self.cfg["feat_dim"])) \
            .astype(np.float32)

    # -- tracing --------------------------------------------------------

    def trace_on(self, section):
        tracer = self.engine.tracer
        tracer.drain()
        tracer.max_traces = 1 << 22
        tracer.sample_rate = 1.0
        section.start()
        self.tracing = self.timer.on = True

    def trace_off(self, section):
        self.tracing = self.timer.on = False
        section.stop()
        self.engine.tracer.sample_rate = 0.0

    def engine_spans(self) -> dict:
        """Host seconds of the engine's ``cache_lookup`` and ``pad`` spans
        over the traced stretch, and the engine calls that made them."""
        host, calls = 0.0, 0

        def walk(sp):
            nonlocal host, calls
            if sp["name"] in ("cache_lookup", "pad") and sp["t_end"]:
                host += sp["t_end"] - sp["t_start"]
                calls += sp["name"] == "cache_lookup"
            for c in sp.get("children", ()):
                walk(c)

        for tr in self.engine.tracer.drain():
            walk(tr["root"])
        return {"host_s": host, "calls": calls}

    def traced_rows(self, section) -> list:
        return [n for t, n in self.topk_calls
                if section.t0 <= t <= section.t1 and n > 0]

    # -- the check ------------------------------------------------------

    def sample(self, n_answers: int) -> np.ndarray:
        n = min(int(self.traffic["check_answers"]), n_answers)
        return np.sort(np.random.RandomState(data.derive(self.seed, "check"))
                       .choice(n_answers, n, replace=False))

    def free_program(self):
        self.close()
        for name in ("engine", "index"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge_answers(self, qrows, dists, ids, precision="f64") -> dict:
        """The numbers of answers (dists, ids) to the pool's rows
        ``qrows``, against the reference in ``precision``; with no answer
        to judge, every number reads as unknown."""
        if len(qrows) == 0:
            return {"bad_answers": 0, "dist_gap": float("inf"),
                    "rank_gap": float("inf")}
        q = torch.from_numpy(self.queries[qrows]).to(self.device)
        top, named = knn.exact(self.L, self.gallery_blocks(), q,
                               torch.as_tensor(ids), self.k, precision)
        return judge.search_numbers(dists, ids, top, named,
                                    self.cfg["n_samples"])

    def control_answers(self, qrows, precision="tf32"):
        """The reference's own answers in a lower precision, which stand
        in the program's place for the control."""
        q = torch.from_numpy(self.queries[qrows]).to(self.device)
        d, i = knn.answers(self.L, self.gallery_blocks(), q, self.k,
                           precision)
        return d.float().cpu().numpy(), i.cpu().numpy()

    def close(self):
        pass
