"""The numbers that decide ``correct``, and their limits.

Training (the first three steps, against the float64 reference):

  * ``loss_gap``: the widest relative gap of a step's loss;
  * ``grad_norm_gap``: the widest relative gap between the norm of a
    worker copy's first gradient, as the optimizer got it (worked out
    from the copy after one step), and the reference's;
  * ``change_norm_gap``: the same for the norm of each copy's change of
    L over the three steps;
  * ``grad_diff``: the norm of the first gradient's difference, over
    the reference's norm (the number the lower-precision control fails:
    its rounding averages away in the norms).

Search (a sample of the window's answers, drawn from the seed):

  * ``dist_gap``: the widest gap between a distance an answer reports
    and the true distance of the row it names;
  * ``rank_gap``: the widest gap between the true distance of an
    answer's j-th row and the true j-th smallest distance;
    both over the query's true k-th distance;
  * ``bad_answers``: answers with a row id outside the gallery, a row
    named twice, or a distance that is not finite;
  * ``lost``: requests of the window that got no answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else math.inf)


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def train_numbers(prog: dict, ref: dict, L0, lr1: float) -> dict:
    """``prog``: {losses, L1 (P, d_out, d_in), L3 (P, ...)} of the program
    (on the host); ``ref``: bsp_sgd's float64 output; ``lr1`` the first
    step's rate. Worked out in float64 on L0's device."""
    dev = L0.device
    L0 = L0.to(torch.float64)
    g_ref = ref["grad1"].to(dev, torch.float64)
    c_ref = ref["params"][2].to(dev, torch.float64) - L0
    gn, cn = _norm(g_ref), _norm(c_ref)
    out = {"loss_gap": max(_rel(a, b) for a, b in
                           zip(prog["losses"], ref["losses"])),
           "grad_norm_gap": 0.0, "change_norm_gap": 0.0, "grad_diff": 0.0}
    for p in range(prog["L1"].shape[0]):
        g = (L0 - prog["L1"][p].to(dev, torch.float64)) / lr1
        c = prog["L3"][p].to(dev, torch.float64) - L0
        out["grad_norm_gap"] = max(out["grad_norm_gap"], _rel(_norm(g), gn))
        out["change_norm_gap"] = max(out["change_norm_gap"],
                                     _rel(_norm(c), cn))
        out["grad_diff"] = max(out["grad_diff"], _norm(g - g_ref) / gn)
        del g, c
    return out


def search_numbers(dists, ids, top, named, n_rows: int) -> dict:
    """``dists`` / ``ids`` (n, k) the answers judged; ``top`` (n, k) the
    true k smallest distances; ``named`` (n, k) the true distances of
    ``ids``; ``n_rows`` the gallery's size."""
    dists = torch.as_tensor(np.asarray(dists), dtype=torch.float64)
    ids = torch.as_tensor(np.asarray(ids)).long()
    top, named = top.double().cpu(), named.double().cpu()
    ok_ids = (ids >= 0) & (ids < n_rows)
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    bad = (~ok_ids.all(dim=1)) | dup | (~torch.isfinite(dists).all(dim=1))
    good = ~bad
    scale = top[:, -1:].clamp_min(1e-30)
    out = {"bad_answers": int(bad.sum())}
    if bool(good.any()):
        out["dist_gap"] = float(((dists - named).abs() / scale)[good].max())
        out["rank_gap"] = float(((named - top).abs() / scale)[good].max())
    else:
        out["dist_gap"] = out["rank_gap"] = math.inf
    return out


def judge(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}} for every number with a limit).
    A number the run could not read counts as over its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        if not value <= limit:          # NaN and inf fail
            correct = False
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
