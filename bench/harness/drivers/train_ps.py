"""Eq. 4 training on the parameter server, step by step through a window.

The loop of ``repro_torch.core.ps.trainer.train_dml_distributed``, run
until the window closes instead of for a fixed count: the PS step of
``core/ps/sync.make_train_step`` over ``core/losses.dml_pair_loss``, SGD
on ``optim/schedules.inverse_time``, batches from ``make_worker_streams``
/ ``stack_worker_streams`` over a pair source that gathers the rows on
the device (``data/pairs.pair_batches_from_indices``), and the step's
metrics read every ``read_every`` steps, as that loop reads them.

Set-up makes the feature pool, the index pairs and L0 from the seed,
builds the one PS state and step, and drives them through their first
``warm_steps`` steps: the first three are the ones the check compares.
The window goes on from there with the same state, step and stream.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.core.ps import sync
from repro_torch.core.ps.trainer import (make_worker_streams,
                                         stack_worker_streams)
from repro_torch.data import pairs as pairdata
from repro_torch.data.loader import partition_pairs
from repro_torch.optim import schedules, sgd

from bench.harness import data, judge
from bench.harness.device import sync as device_sync
from bench.harness.profile import RangeTimer, Section
from bench.reference import dml as ref

CHECK_STEPS = 3
LOSS_RANGE = "bench.loss_fwd"


class IndexPairs:
    """The pair source: index pairs over a feature pool on the device,
    partitioned over workers (paper §4.1), each worker's batches gathered
    on the device by index."""

    def __init__(self, features, idx, device):
        self.features, self.idx, self.device = features, idx, device

    def worker_streams(self, n_workers, batch_size, seed):
        return [pairdata.pair_batches_from_indices(
            self.features, shard, batch_size, seed=seed + i,
            device=self.device)
            for i, shard in enumerate(partition_pairs(self.idx, n_workers))]


class Driver:

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.P = int(traffic["workers"])
        self.B = int(cfg["batch_size"])
        self.ps_seed = data.derive(seed, "ps")
        self.hooks = []         # called at the end of build (faults)
        self.timer = RangeTimer(self.device)

    # -- set-up ---------------------------------------------------------

    def make_inputs(self):
        cfg, dev = self.cfg, self.device
        classes = data.make_classes(self.seed, cfg["n_classes"],
                                    cfg["feat_dim"], cfg["sparsity"], dev)
        labels = data.make_labels(self.seed, "pool", cfg["train_rows"],
                                  cfg["n_classes"], dev)
        self.pool = data.fill_rows(self.seed, "pool", labels, classes,
                                   cfg["noise"])
        del classes
        self.pairs = data.pair_indices(self.seed, labels, cfg["n_similar"],
                                       cfg["n_dissimilar"])
        del labels
        L = data.metric_factor(self.seed, cfg["proj_dim"], cfg["feat_dim"],
                               dev)
        # scale L so that a probe of the pairs reads mean ||Lz||^2 of
        # twice the margin: the hinge is live for part of the dissimilar
        # pairs from the first step
        n = min(256, len(self.pairs["sim"]))
        a = torch.from_numpy(self.pairs["a"][:n]).to(dev)
        b = torch.from_numpy(self.pairs["b"][:n]).to(dev)
        z = (self.pool[a] - self.pool[b]).double()
        d2 = float(torch.mean(torch.sum((z @ L.double().T) ** 2, dim=1)))
        self.L0 = (L * math.sqrt(2.0 * cfg["margin"] / d2)).contiguous()

    def build(self):
        self.make_inputs()
        cfg, tr = self.cfg, self.traffic
        self.opt = sgd(schedules.inverse_time(tr["lr0"], tr["lr_decay"]))
        self.ps = sync.PSConfig(n_workers=self.P, sync=tr["sync"],
                                seed=self.ps_seed)
        self.state = sync.init_state(self.opt, self.L0.clone(), self.ps)

        def loss_fn(L, batch):
            return losses.dml_pair_loss(L, batch, lam=cfg["lam"],
                                        margin=cfg["margin"])

        self.loss_fn = loss_fn = self.timer.wrap(loss_fn, LOSS_RANGE)
        self.step_fn = sync.make_train_step(loss_fn, self.opt, self.ps)
        self.batches = stack_worker_streams(make_worker_streams(
            IndexPairs(self.pool, self.pairs, self.device), self.P, self.B,
            self.ps_seed, device=self.device))
        for hook in self.hooks:
            hook(self)

    def warm(self):
        """The first steps: the check's three, then the rest of the warm
        steps, every step's metrics read."""
        self.first = {"losses": []}
        for t in range(1, max(CHECK_STEPS, int(self.traffic["warm_steps"]))
                       + 1):
            self.state, m = self.step_fn(self.state, next(self.batches))
            loss = float(m["loss"])
            if t <= CHECK_STEPS:
                self.first["losses"].append(loss)
            if t == 1:
                self.first["L1"] = self.state.params.detach().cpu()
            if t == CHECK_STEPS:
                self.first["L3"] = self.state.params.detach().cpu()
        device_sync(self.device)

    # -- the window -----------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        tr = self.traffic
        every = int(tr["read_every"])
        t_from, t_steps = int(tr["trace_from_step"]), int(tr["trace_steps"])
        section = Section(self.device) if trace else None
        steps = failed = traced_steps = 0
        reads = []
        device_sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.state, m = self.step_fn(self.state, next(self.batches))
            steps += 1
            if steps % every:
                continue
            rec = {k: float(v) for k, v in m.items()}
            if not all(math.isfinite(v) for v in rec.values()):
                failed += every
            now = time.perf_counter()
            reads.append(now)
            if section is not None:
                if steps == t_from:
                    section.start()
                    self.timer.on = True
                    start_step = steps
                elif section.running and steps >= t_from + t_steps:
                    self.timer.on = False
                    section.stop()
                    traced_steps = steps - start_step
            if now - t0 >= seconds:
                break
        device_sync(self.device)
        t_end = time.perf_counter()
        per = np.diff([t0] + reads) / every * 1e3
        print(f"train: {steps} steps; ms a step between reads p10 "
              f"{np.percentile(per, 10):.3f}, p50 {np.percentile(per, 50):.3f}"
              f", p90 {np.percentile(per, 90):.3f}, max {per.max():.3f}",
              file=sys.stderr)
        if section is not None and section.running:
            self.timer.on = False
            section.stop()
            traced_steps = steps - start_step
        out = {"seconds": t_end - t0, "steps": steps, "failed": failed,
               "attempted": steps, "pairs": steps * self.P * self.B,
               "traced_steps": traced_steps,
               "traced_s": section.span_s if traced_steps else 0.0,
               "section": section,
               "ranges": {LOSS_RANGE: self.timer.read()}}
        return out

    def end_to_end(self, win: dict) -> dict:
        return {"train_pairs_per_s": win["pairs"] / win["seconds"]}

    # -- the check ------------------------------------------------------

    def free_program(self):
        for name in ("state", "step_fn", "batches", "opt", "loss_fn"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f64") -> dict:
        cfg, tr = self.cfg, self.traffic
        return ref.bsp_sgd(self.pool, self.pairs, self.L0, self.P, self.B,
                           self.ps_seed, tr["lr0"], tr["lr_decay"],
                           CHECK_STEPS, cfg["lam"], cfg["margin"], precision)

    def lr1(self) -> float:
        return ref.lr_at(self.traffic["lr0"], self.traffic["lr_decay"], 1)

    def check(self, win: dict) -> dict:
        """The numbers of the first three steps against the float64
        reference (run after the program's state is freed)."""
        self.free_program()
        self.ref64 = self.reference("f64")
        return judge.train_numbers(self.first, self.ref64, self.L0,
                                   self.lr1())

    def close(self):
        pass


def as_program_output(out: dict, n_workers: int) -> dict:
    """bsp_sgd's output in the program's shape (every worker copy the
    same), for reading a reference run in the program's place."""
    return {"losses": out["losses"],
            "L1": out["params"][0].float().cpu()[None].repeat(
                n_workers, 1, 1),
            "L3": out["params"][CHECK_STEPS - 1].float().cpu()[None].repeat(
                n_workers, 1, 1)}

