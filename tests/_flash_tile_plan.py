"""The bf16 flash kernel's tile plans against a brute-force numpy mask:
the (T, S, causal, window, Dh) cases, the (T, S, causal, window, Dh,
q_offset) ones of a query slice at an offset, and the check that the CPU
tests run on ``kernel.py::tile_plan`` and the card tests on the CUDA
source's own classification."""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.flash_attention.cases import PARITY
from repro_torch.kernels.flash_attention.kernel import (BLOCK_Q, EDGE, FULL,
                                                        SKIP, block_k)

# (T, S, causal, window, Dh) of the card parity cases (cases.PARITY), then
# T = S at the tile edges (79, 80, 81, 127, 128, 129) and at the service's
# 8192, each with no window and windows 1, 64, 80, 127, 128 and 4096,
# causal and not, at both kv tile widths (Dh 80: 128 keys, Dh 256: 80)
PARITY_PLANS = sorted({(T, S, causal, window, dh) for _, T, S, _, _, dh,
                       causal, window, off in PARITY if off == 0})
EDGE_PLANS = [(T, T, causal, window, dh)
              for T in (79, 80, 81, 127, 128, 129, 8192)
              for window in (0, 1, 64, 80, 127, 128, 4096)
              for causal in (True, False) for dh in (80, 256)]
# (T, S, causal, window, Dh, q_offset): the parity cases at an offset,
# then a slice of 128 or 200 rows at offsets on and off the tiles (1,
# 127, 128, 129, 3584) against the keys up to its last position and
# against S 4096, with no window and windows 1 and 100, causal and not,
# at both kv tile widths
OFFSET_PLANS = sorted(
    {(T, S, causal, window, dh, off) for _, T, S, _, _, dh, causal, window,
     off in PARITY if off} |
    {(T, S, causal, window, dh, off)
     for T in (128, 200) for off in (1, 127, 128, 129, 3584)
     for S in (T + off, 4096) for window in (0, 1, 100)
     for causal in (True, False) for dh in (80, 256)
     if not window or T + off - window < S})


def _tile_any(pairs, bq, bk, shape):
    """(q tiles, kv tiles): whether a tile holds a True pair."""
    pad = np.zeros((shape[0] * bq, shape[1] * bk), bool)
    pad[:pairs.shape[0], :pairs.shape[1]] = pairs
    return pad.reshape(shape[0], bq, shape[1], bk).any(axis=(1, 3))


def check_plan_against_mask(plan, T, S, causal, window, dh, q_offset=0):
    """Skipped tiles hold no allowed (t, s) pair and full tiles no masked
    one (rows below T, row t at position t + q_offset; a key past S
    counts as masked), and the visited tiles of a q tile are one run."""
    bk = block_k(dh)
    assert plan.shape == (-(-T // BLOCK_Q), -(-S // bk))
    assert set(np.unique(plan)) <= {SKIP, EDGE, FULL}
    t = np.arange(T)[:, None] + q_offset
    s = np.arange(plan.shape[1] * bk)[None, :]
    ok = s < S
    if causal:
        ok = ok & (s <= t)
    if window:
        ok = ok & (s > t - window)
    allowed = _tile_any(ok, BLOCK_Q, bk, plan.shape)
    masked = _tile_any(~ok, BLOCK_Q, bk, plan.shape)
    assert not allowed[plan == SKIP].any()
    assert not masked[plan == FULL].any()
    for row in plan:
        seen = np.flatnonzero(row != SKIP)
        assert seen.size == 0 or np.all(row[seen[0]:seen[-1] + 1] != SKIP)
