"""Mined pair source: the miner's output as a trainer-ready batch stream.

Counterpart of ``repro/mining/stream.py``. ``MinedPairSource`` satisfies
the pluggable pair-source contract ``core/ps/trainer`` accepts (an object
with ``worker_streams(n_workers, batch_size, seed)``): each worker gets an
infinite iterator of ``{"xs", "ys", "sim"}`` batches, the shape
``data/pairs.pair_batches`` yields.

Each batch mixes two origins under a ratio schedule:

  uniform  pairs freshly rejection-sampled from the label table
           (``data/pairs.sample_pair_indices`` semantics: balanced S/D,
           self-pairs masked, no duplicates within the draw);
  mined    pairs drawn from the miner's latest *pool* (index pairs
           produced by ``HardPairMiner.mine``; ``set_pool`` swaps it in
           after every closed-loop refresh).

The schedule is the curriculum: warm up on pure uniform pairs, then
anneal linearly toward ``max_mined_frac``. Worker w owns pool rows
``w::n_workers`` and a distinct uniform seed; within a batch both shares
are duplicate-free.

Where the reference gathers each batch's rows on the host and copies them
to the device, the feature table here stays resident on the source's
device (the card unless ``device="cpu"``) and each batch is gathered there
by index tensors: at d_in 21504 the host route would move 172 MB a worker
a step. The index draws are the reference's ``RandomState`` draws in the
same order, so every batch holds the reference's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.data.pairs import distinct_draws, sample_pair_indices
from repro_torch.device import host_array, resolve_device


@dataclasses.dataclass(frozen=True)
class CurriculumSchedule:
    """Mined-pair fraction as a function of the (per-worker) step.

    warmup_steps of pure uniform, then a linear ramp over ramp_steps up
    to max_mined_frac, constant after. max_mined_frac=0 degenerates to
    the uniform stream (an ablation baseline).
    """

    warmup_steps: int = 50
    ramp_steps: int = 100
    max_mined_frac: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.max_mined_frac <= 1.0:
            raise ValueError(f"max_mined_frac must be in [0, 1], got "
                             f"{self.max_mined_frac}")
        if self.warmup_steps < 0 or self.ramp_steps < 0:
            raise ValueError("warmup_steps / ramp_steps must be >= 0")

    def mined_frac(self, step: int) -> float:
        if step < self.warmup_steps:
            return 0.0
        if self.ramp_steps == 0:
            return self.max_mined_frac
        ramp = (step - self.warmup_steps) / self.ramp_steps
        return self.max_mined_frac * min(ramp, 1.0)


class MinedPairSource:
    """Curriculum mix of uniform and mined pair batches, per-worker
    sharded. Satisfies the trainer's pluggable pair-source contract."""

    def __init__(self, features, labels,
                 schedule: Optional[CurriculumSchedule] = None, *,
                 balanced_uniform: bool = True, device=None):
        """Args:
          features / labels: the (n, d) feature table and (n,) labels
            every pair (mined or uniform) indexes into. ``features`` is
            placed on ``device`` once (an f32 tensor already there is
            used as it is, without a copy).
          schedule: curriculum (CurriculumSchedule defaults).
          balanced_uniform: draw the uniform share half-S / half-D (the
            paper's §5.2 setup); mined pairs keep whatever S/D mix the
            miner produced.
          device: where the table lives and batches are gathered (the
            card by default).
        """
        self.device = resolve_device(device)
        self.features = torch.as_tensor(features, dtype=torch.float32).to(
            self.device)
        self.labels = host_array(labels)
        self.schedule = schedule or CurriculumSchedule()
        self.balanced_uniform = balanced_uniform
        self._pool = {"a": np.zeros(0, np.int64),
                      "b": np.zeros(0, np.int64),
                      "sim": np.zeros(0, np.int32)}
        self.pool_version = 0

    # -- pool lifecycle ------------------------------------------------------

    @property
    def pool_size(self) -> int:
        return int(self._pool["sim"].shape[0])

    def set_pool(self, pairs: dict) -> None:
        """Swap in a freshly mined pool (dict(a, b, sim) index pairs, or
        a MiningResult's ``.pairs``). Streams pick it up on their next
        batch — no stream restart needed."""
        pairs = getattr(pairs, "pairs", pairs)
        a = host_array(pairs["a"], np.int64)
        b = host_array(pairs["b"], np.int64)
        sim = host_array(pairs["sim"], np.int32)
        if not (a.shape == b.shape == sim.shape):
            raise ValueError("pool arrays must be same-shape 1-D")
        n = self.features.shape[0]
        if len(a) and (max(a.max(), b.max()) >= n or min(a.min(),
                                                         b.min()) < 0):
            raise ValueError("pool indices out of range of the feature "
                             "table")
        self._pool = {"a": a, "b": b, "sim": sim}
        self.pool_version += 1

    # -- the trainer contract ------------------------------------------------

    def worker_streams(self, n_workers: int, batch_size: int,
                       seed: int = 0) -> List[Iterator[dict]]:
        """One infinite batch iterator per worker (disjoint shards)."""
        return [self.worker_stream(w, n_workers, batch_size, seed)
                for w in range(n_workers)]

    def worker_stream(self, worker: int, n_workers: int, batch_size: int,
                      seed: int = 0) -> Iterator[dict]:
        """Worker ``worker``'s stream of ``worker_streams``: what a rank
        of a worker mesh draws (``mining/loop.py``)."""
        return self._stream(worker, n_workers, batch_size, seed + worker)

    def _draw(self, rng, worker: int, n_workers: int, batch_size: int,
              step: int):
        """One batch's (a, b, sim) host index arrays, in batch order:
        the reference's draws, in its order."""
        frac = self.schedule.mined_frac(step)
        # worker's shard of the current pool (recomputed per batch:
        # set_pool may have swapped it since the last one)
        pa = self._pool["a"][worker::n_workers]
        pb = self._pool["b"][worker::n_workers]
        ps = self._pool["sim"][worker::n_workers]
        n_mined = min(int(round(frac * batch_size)), len(pa))
        n_uni = batch_size - n_mined
        parts_a, parts_b, parts_s = [], [], []
        if n_mined:
            # distinct rows per batch, matching the dedup contract the
            # uniform share gets from sample_pair_indices
            sel = distinct_draws(rng, len(pa), n_mined)
            parts_a.append(pa[sel])
            parts_b.append(pb[sel])
            parts_s.append(ps[sel])
        if n_uni:
            if self.balanced_uniform:
                n_sim = n_uni // 2
                n_dis = n_uni - n_sim
            else:
                n_sim = int(rng.binomial(n_uni, 0.5))
                n_dis = n_uni - n_sim
            uni = sample_pair_indices(
                self.labels, n_sim, n_dis,
                seed=int(rng.randint(0, 2 ** 31 - 1)))
            parts_a.append(uni["a"])
            parts_b.append(uni["b"])
            parts_s.append(uni["sim"])
        perm = rng.permutation(batch_size)
        return (np.concatenate(parts_a)[perm], np.concatenate(parts_b)[perm],
                np.concatenate(parts_s)[perm])

    def _stream(self, worker: int, n_workers: int, batch_size: int,
                seed: int) -> Iterator[dict]:
        rng = np.random.RandomState(seed)
        dev = self.device
        step = 0
        while True:
            a, b, sim = self._draw(rng, worker, n_workers, batch_size, step)
            yield {"xs": self.features[torch.from_numpy(a).to(dev)],
                   "ys": self.features[torch.from_numpy(b).to(dev)],
                   "sim": torch.from_numpy(sim).to(dev)}
            step += 1
