"""Plain reference of the search cells: exact kNN under ||L(q - g)||^2.

The gallery's raw rows are made again block by block by the caller's
``blocks`` (the same generator calls that made them for the program),
projected through L here, and scanned against the projected queries.
For each query the reference gives the k smallest true distances in
order and the true distance of every row id that an answer names, so an
answer is judged by what it says: the distances it reports, and whether
its rows are the k nearest.

Imports torch only.
"""

from __future__ import annotations

import torch

from bench.reference.precision import dtype, matmul


def project(L, x, precision: str) -> torch.Tensor:
    """x (n, d_in) @ L.T in ``precision``."""
    return matmul(x, L.T, precision)


def sqdist(qp, gp) -> torch.Tensor:
    """(nq, m) squared distances qn + gn - 2 qp.gp in qp's dtype. In
    float64 the expansion's cancellation costs ~1e-15 of qn + gn, far
    below the float32 rounding that the program's answers carry."""
    qn = torch.sum(qp * qp, dim=1, keepdim=True)
    gn = torch.sum(gp * gp, dim=1)
    return torch.clamp_min(qn + gn[None, :] - 2.0 * (qp @ gp.T), 0.0)


def exact(L, blocks, queries, ids, k: int, precision: str = "f64"):
    """The true answers and the true distance of each named row.

    ``blocks`` yields (first row, raw rows) of the gallery in order;
    ``queries`` (n, d_in) raw; ``ids`` (n, k) the rows the answers name
    (any int; out-of-range ids read inf). Returns (top (n, k) the k
    smallest distances ascending, named (n, k) the distances of
    ``ids``)."""
    dt = dtype(precision)
    qp = project(L, queries, precision).to(dt)
    n = qp.shape[0]
    top = torch.full((n, k), float("inf"), dtype=dt, device=qp.device)
    named = torch.full((n, k), float("inf"), dtype=dt, device=qp.device)
    ids = ids.to(qp.device).long()
    for r0, raw in blocks:
        gp = project(L, raw, precision).to(dt)
        d = sqdist(qp, gp)
        top = torch.topk(torch.cat([top, d], dim=1), k, dim=1,
                         largest=False).values
        here = (ids >= r0) & (ids < r0 + gp.shape[0])
        rows, cols = torch.nonzero(here, as_tuple=True)
        named[rows, cols] = d[rows, ids[rows, cols] - r0]
    return top, named


def answers(L, blocks, queries, k: int, precision: str):
    """The reference's own top-k (dists, ids) of ``queries``, factored as
    the program scans (qn + gn - 2 qp.gp), in ``precision``: in tf32 this
    is the control that stands in the program's place."""
    dt = dtype(precision)
    qp = project(L, queries, precision).to(dt)
    qn = torch.sum(qp * qp, dim=1, keepdim=True)
    best_d = torch.full((qp.shape[0], k), float("inf"), dtype=dt,
                        device=qp.device)
    best_i = torch.zeros((qp.shape[0], k), dtype=torch.long, device=qp.device)
    for r0, raw in blocks:
        gp = project(L, raw, precision).to(dt)
        gn = torch.sum(gp * gp, dim=1)
        d = torch.clamp_min(qn + gn[None, :]
                            - 2.0 * matmul(qp, gp.T, precision), 0.0)
        idx = torch.arange(r0, r0 + gp.shape[0], device=qp.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, idx[None, :].expand(qp.shape[0], -1)],
                          dim=1)
        best_d, pos = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = torch.gather(cat_i, 1, pos)
    return best_d, best_i
