"""Batch pipeline helpers (counterpart of ``repro/data/loader.py``):
per-worker partitioning of the pair sets (paper §4.1: "we partition the
similar pairs and dissimilar pairs onto different machines"),
``shard_batch`` (this rank's block of a host batch over a live mesh, on
its device), a background prefetcher and ``take``.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.sharding import partition


def partition_pairs(pairs: dict, n_workers: int):
    """Split a pair dict into n_workers shards (S_p, D_p as in the paper)."""
    n = pairs["sim"].shape[0]
    shards = np.array_split(np.arange(n), n_workers)
    return [{k: v[s] for k, v in pairs.items()} for s in shards]


def shard_batch(batch: dict, spec, mesh) -> dict:
    """This rank's block of every leaf of a host batch placed by ``spec``
    over a live ``mesh`` (e.g. ``("workers",)`` for a (P, B, ...) worker
    batch), moved to the rank's device; only the block leaves the host."""
    return {k: partition.block(torch.as_tensor(v), spec, mesh)
            .to(mesh.device) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def take(it: Iterator, n: int):
    return itertools.islice(it, n)
