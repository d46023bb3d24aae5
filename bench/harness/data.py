"""The benchmark's inputs, made on the device from ``--seed``.

The rows follow the llc-like recipe of the port's smoke script
(``chip_smoke.class_rows`` / ``make_gallery``, copied here so that the
yardstick stays put when the program changes): each class has a support
mask over ``1 - sparsity`` of the dimensions and |N(0, 1)| magnitudes on
it; a row of the class is its magnitudes plus ``noise`` x |N(0, 1)| on
the mask. Every block of rows has a generator of its own, seeded from
(seed, name, block), so any block can be made again, bit for bit, by the
reference after the window.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

BLOCK = 16384           # rows a generated block


def derive(seed: int, *parts) -> int:
    """A sub-seed below 2**31 for ``parts`` under the run's ``seed``."""
    key = ":".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:4], "little") \
        & 0x7FFFFFFF


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


class Classes(NamedTuple):
    mags: torch.Tensor      # (n_classes, d_in) |center| on the mask
    masks: torch.Tensor     # (n_classes, d_in) bool support masks


def make_classes(seed: int, n_classes: int, d_in: int, sparsity: float,
                 device) -> Classes:
    g = generator(device, seed, "classes")
    centers = torch.randn((n_classes, d_in), generator=g, device=device)
    masks = torch.rand((n_classes, d_in), generator=g,
                       device=device) < (1.0 - sparsity)
    return Classes(centers.abs() * masks, masks)


def make_labels(seed: int, name: str, n: int, n_classes: int,
                device) -> torch.Tensor:
    g = generator(device, seed, name, "labels")
    return torch.randint(0, n_classes, (n,), generator=g, device=device)


def blocks(n: int, block: int = BLOCK) -> Iterator[Tuple[int, int, int]]:
    """(block index, first row, end row) over ``n`` rows."""
    for b, b0 in enumerate(range(0, n, block)):
        yield b, b0, min(n, b0 + block)


def rows(seed: int, name: str, b: int, labels: torch.Tensor,
         classes: Classes, noise: float) -> torch.Tensor:
    """Block ``b`` of the rows called ``name``: one row a label."""
    g = generator(labels.device, seed, name, "block", b)
    mags, masks = classes
    return mags[labels] + noise * torch.randn(
        (len(labels), mags.shape[1]), generator=g,
        device=labels.device).abs() * masks[labels]


def fill_rows(seed: int, name: str, labels: torch.Tensor, classes: Classes,
              noise: float) -> torch.Tensor:
    """All rows called ``name`` in one (n, d_in) f32 tensor, made block by
    block."""
    out = torch.empty((len(labels), classes.mags.shape[1]),
                      dtype=torch.float32, device=labels.device)
    for b, b0, b1 in blocks(len(labels)):
        out[b0:b1] = rows(seed, name, b, labels[b0:b1], classes, noise)
    return out


def metric_factor(seed: int, d_out: int, d_in: int, device) -> torch.Tensor:
    """L (d_out, d_in) f32, N(0, 1 / d_in) entries."""
    g = generator(device, seed, "L")
    return torch.randn((d_out, d_in), generator=g, device=device) \
        / math.sqrt(d_in)


def pair_indices(seed: int, labels: torch.Tensor, n_similar: int,
                 n_dissimilar: int) -> dict:
    """Index pairs over the rows of ``labels``: ``n_similar`` of two
    distinct rows of one class, ``n_dissimilar`` of rows of two classes,
    shuffled together. Drawn on the device; returned as host arrays
    {a, b: int64, sim: int32}, the pair source's format."""
    dev = labels.device
    g = generator(dev, seed, "pairs")
    n = len(labels)
    counts = torch.bincount(labels)
    if int(counts[counts > 0].min()) < 2:
        raise ValueError("a class holds fewer than two rows")
    order = torch.argsort(labels, stable=True)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(labels)
    pos[order] = torch.arange(n, device=dev) - offsets[labels[order]]
    a = torch.randint(0, n, (n_similar,), generator=g, device=dev)
    c, cnt = labels[a], counts[labels[a]]
    step = 1 + (torch.rand((n_similar,), generator=g, device=dev)
                * (cnt - 1)).long()
    b = order[offsets[c] + (pos[a] + step) % cnt]
    da = torch.randint(0, n, (n_dissimilar,), generator=g, device=dev)
    db = torch.randint(0, n, (n_dissimilar,), generator=g, device=dev)
    same = labels[da] == labels[db]
    while bool(same.any()):
        db[same] = torch.randint(0, n, (int(same.sum()),), generator=g,
                                 device=dev)
        same = labels[da] == labels[db]
    perm = torch.randperm(n_similar + n_dissimilar, generator=g, device=dev)
    sim = torch.cat([torch.ones(n_similar, dtype=torch.int32, device=dev),
                     torch.zeros(n_dissimilar, dtype=torch.int32,
                                 device=dev)])
    return {"a": torch.cat([a, da])[perm].cpu().numpy().astype(np.int64),
            "b": torch.cat([b, db])[perm].cpu().numpy().astype(np.int64),
            "sim": sim[perm].cpu().numpy()}


def exponential_gaps(seed: int, n: int, rate: float) -> np.ndarray:
    """``n`` gaps of a Poisson arrival process at ``rate`` a second: the
    exponential distribution's n quantiles at (i + 1/2) / n, in an order
    drawn from the seed. Every seed offers the same gaps, so the same
    load, in another order."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return gaps[np.random.RandomState(derive(seed, "arrivals")).permutation(n)]
