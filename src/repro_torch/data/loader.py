"""Batch pipeline helpers (counterpart of ``repro/data/loader.py``):
per-worker partitioning of the pair sets (paper §4.1: "we partition the
similar pairs and dissimilar pairs onto different machines"), a
background prefetcher and ``take``. The reference's ``shard_batch``
places a batch over a device mesh and waits for the multi-GPU slice.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np


def partition_pairs(pairs: dict, n_workers: int):
    """Split a pair dict into n_workers shards (S_p, D_p as in the paper)."""
    n = pairs["sim"].shape[0]
    shards = np.array_split(np.arange(n), n_workers)
    return [{k: v[s] for k, v in pairs.items()} for s in shards]


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
