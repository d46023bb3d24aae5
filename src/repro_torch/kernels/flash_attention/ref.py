"""Plain PyTorch version of the flash attention kernel (GQA, causal /
sliding window): the port of ``repro/kernels/flash_attention/ref.py``.

The softmax of each query row is taken over all S keys at once, as the
reference's oracle does; the rows are only walked in blocks of
``q_block`` so that the (B, K, G, rows, S) f32 scores of a long sequence
stay a few GB at most. Splitting the rows changes no arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._dispatch import full_f32

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float = None, q_block: int = 1024,
                  q_offset: int = 0):
    """q (B,T,H,Dh); k,v (B,S,K,Dh) with H % K == 0. Returns (B,T,H,Dh)
    in q's dtype, computed in f32.

    Query row t sits at position t + q_offset. window > 0 limits
    attention to the last ``window`` positions (sliding): key s is seen
    by the query at position p when p - window < s (and s <= p when
    causal).
    """
    full_f32()
    B, T, H, dh = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = float(scale or 1.0 / np.sqrt(dh))
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(S, device=q.device)
    outs = []
    for t0 in range(0, T, q_block):
        t1 = min(T, t0 + q_block)
        qg = q[:, t0:t1].reshape(B, t1 - t0, K, H // K, dh)
        s = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                         kf) * scale
        qpos = torch.arange(t0, t1, device=q.device) + q_offset
        mask = torch.ones((t1 - t0, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgts,bskd->btkgd", w, vf)
        outs.append(out.reshape(B, t1 - t0, H, dh))
    return torch.cat(outs, dim=1).to(q.dtype)
