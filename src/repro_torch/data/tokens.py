"""Synthetic LM token streams for backbone training / smoke / bench runs
(counterpart of ``repro/data/tokens.py``).

Deterministic Markov-ish structure (not pure uniform noise) so a trained
LM loss actually decreases, which the end-to-end driver asserts. The
draws are the reference's ``RandomState`` calls in the reference's
order, so every batch is bit-equal to the reference's for the same seed;
only the container differs (tensors on ``device``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def token_stream(vocab_size: int, batch_size: int, seq_len: int,
                 seed: int = 0, device=None) -> Iterator[dict]:
    """Yields {tokens (B, T) int32, labels (B, T) int32} batches forever,
    on ``device`` (the card unless "cpu").

    Sequences follow x_{t+1} = (a * x_t + b + noise) mod V with
    per-sequence (a, b) so there is learnable next-token structure.
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    # a FIXED set of transition modes (drawn once): the stream is
    # stationary, so a trained LM's loss actually decreases
    n_modes = 4
    mode_a = rng.randint(1, 5, size=n_modes)
    mode_b = rng.randint(0, vocab_size, size=n_modes)
    while True:
        m = rng.randint(0, n_modes, size=(batch_size, 1))
        a, b = mode_a[m], mode_b[m]
        x0 = rng.randint(0, vocab_size, size=(batch_size, 1))
        toks = np.empty((batch_size, seq_len + 1), np.int64)
        toks[:, :1] = x0
        for t in range(seq_len):
            noise = rng.randint(0, 3, size=(batch_size, 1))
            toks[:, t + 1:t + 2] = (a * toks[:, t:t + 1] + b + noise) \
                % vocab_size
        yield {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev),
        }


def embedding_stream(embed_dim: int, batch_size: int, seq_len: int,
                     n_classes: int = 16, seed: int = 0,
                     device=None) -> Iterator[dict]:
    """Precomputed frame/patch embedding batches for the audio/VLM
    frontends (the one sanctioned stub): {embeddings (B, T, D) f32,
    labels (B,) int32} on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, embed_dim).astype(np.float32)
    while True:
        cls = rng.randint(0, n_classes, size=batch_size)
        e = centers[cls][:, None, :] + 0.5 * rng.randn(
            batch_size, seq_len, embed_dim).astype(np.float32)
        yield {"embeddings": torch.from_numpy(e).to(dev),
               "labels": torch.from_numpy(cls.astype(np.int32)).to(dev)}
