"""ctypes wrapper of the hand-written Hopper kernel ``csrc/ivf_scan.cu``.

Counterpart of ``repro/kernels/ivf_scan/kernel.py::ivf_scan_topk_fused``:
per query, score the rows of its probed full-precision segments with
the factored distance and keep the top kk, without the (Nq, nprobe,
cap, k) segment gather reaching device memory, for every kk the
reference takes (1 <= kk <= nprobe * cap): lists of up to ``LIST_K``
candidates are kept in shared memory; a wider kk takes the wide path
(every distance to a scratch buffer, then a radix select).

The kernel is cluster-major: a plan kernel sorts the (query, probe)
pairs by segment on the card and cuts each segment's run into groups of
at most ``GROUP`` pairs; one scan block per (group, row chunk) reads the
segment once for the whole group. ``work_plan`` is that plan in plain
torch (the CPU tests hold it, and the card tests hold the kernel's own,
``device_plan``, to it). The library is built on first use
(``kernels/_build.py``); nothing here touches CUDA at import time. The
wrapper checks its inputs, allocates outputs and scratch with
``torch.empty``, launches on the current stream without synchronising
(the group count stays on the card), raises on a non-zero
``cudaError_t``, and counts its calls in ``ivf_scan_topk_fused.launches``
(one call = the plan, scan and merge or select launches).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import (cdiv, check_kk, check_tensor,
                                         event_handles, segment_scratch,
                                         segment_split, sm_count)

SOURCE = Path(__file__).resolve().parent / "csrc" / "ivf_scan.cu"
LIST_K = 256            # widest per-pair lists; a wider kk goes wide
TILE_ROWS = 32          # segment rows of a tile (8 warps x 4 rows)
GROUP = 8               # pairs a group: one warp keeps each pair's list
PLAN_MAX = 8192         # pairs one plan launch sorts; more go in turns
SLICE, STAGES = 128, 3  # k floats of a staged slice; slices in flight
SMEM_LIMIT = 232_448 - 1024     # a block's shared memory, less static use

_lib = None


def smem_bytes(kk: int) -> int:
    """Dynamic shared memory of one scan block (as ``csrc`` computes it):
    three stages of a 32-row x 128-float segment slice and the group's 8
    query slices, an 8 x 32 distance tile, and eight (d, position) lists
    of kk (none on the wide path, kk > LIST_K). It does not depend on k:
    the query rows stream through the stages too."""
    lists = GROUP * kk * 8 if kk <= LIST_K else 0
    stage = (TILE_ROWS + GROUP) * SLICE * 4
    return STAGES * stage + 4 * GROUP * TILE_ROWS + lists


def max_groups(npairs: int, n_clusters: int) -> int:
    """Most groups the plan can make of ``npairs`` pairs (the scan grid's
    size): sum over segments of ceil(n_s / GROUP), at most one a pair."""
    distinct = min(npairs, n_clusters)
    return min(npairs, cdiv(npairs + distinct * (GROUP - 1), GROUP))


def work_plan(probes: torch.Tensor, n_clusters: int):
    """The kernel's order of work in plain torch, one entry per plan
    launch (``PLAN_MAX`` pairs each): (pair0, order, gfirst, gcount,
    gseg). ``order`` holds the launch's pairs (pair = q * nprobe + p,
    global) sorted by (clipped segment, pair); group g is order[gfirst[g]
    : gfirst[g] + gcount[g]], at most ``GROUP`` pairs of segment gseg[g],
    each segment's run cut from its start. int64 tensors on probes'
    device."""
    seg_all = probes.reshape(-1).long().clamp(0, n_clusters - 1)
    rounds = []
    for pair0 in range(0, seg_all.numel(), PLAN_MAX):
        seg = seg_all[pair0:pair0 + PLAN_MAX]
        idx = torch.sort(seg, stable=True).indices
        s = seg[idx]
        n = s.numel()
        pos = torch.arange(n, device=s.device)
        new_run = torch.ones(n, dtype=torch.bool, device=s.device)
        new_run[1:] = s[1:] != s[:-1]
        run0 = torch.cummax(torch.where(new_run, pos, 0), 0).values
        run_len = torch.bincount(torch.cumsum(new_run.long(), 0) - 1)
        run1 = run0 + run_len[torch.cumsum(new_run.long(), 0) - 1]
        start = (pos - run0) % GROUP == 0
        gfirst = pos[start]
        gcount = torch.clamp(run1[start] - gfirst, max=GROUP)
        rounds.append((pair0, idx + pair0, gfirst, gcount, s[gfirst]))
    return rounds


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ivf_scan_launch.argtypes = [p] * 11 + [i] * 9 + [p, p]
        lib.ivf_scan_launch.restype = i
        lib.ivf_scan_plan.argtypes = [p] * 2 + [i] * 2 + [p]
        lib.ivf_scan_plan.restype = i
        lib.ivf_scan_max_groups.argtypes = [i, i]
        lib.ivf_scan_smem_bytes.argtypes = [i]
        lib.ivf_scan_smem_bytes.restype = ctypes.c_longlong
        if (lib.ivf_scan_max_k(), lib.ivf_scan_tile_rows(),
                lib.ivf_scan_group_pairs(), lib.ivf_scan_plan_max(),
                [lib.ivf_scan_smem_bytes(kk) for kk in (0, 10, 256)],
                [lib.ivf_scan_max_groups(*a) for a in
                 ((1024, 1024), (16, 1024), (64, 3), (8192, 40))]) != (
                    LIST_K, TILE_ROWS, GROUP, PLAN_MAX,
                    [smem_bytes(kk) for kk in (0, 10, 256)],
                    [max_groups(*a) for a in
                     ((1024, 1024), (16, 1024), (64, 3), (8192, 40))]):
            raise RuntimeError(f"{SOURCE} disagrees with kernel.py on its "
                               f"tile, group and shared-memory sizes")
        _lib = lib
    return _lib


def device_plan(probes: torch.Tensor, n_clusters: int):
    """The plan kernel's own work plan of ``probes`` (at most PLAN_MAX
    pairs, on the card): (order, gfirst, gcount, gseg) int64 on the
    host, cut to the group count, comparable with one round of
    ``work_plan``."""
    npairs = probes.numel()
    if probes.device.type != "cuda" or not 1 <= npairs <= PLAN_MAX:
        raise ValueError(f"device_plan takes 1..{PLAN_MAX} probes on a "
                         f"CUDA device, got {npairs} on {probes.device}")
    probes = probes.to(torch.int32).contiguous()
    plan = torch.zeros(4 * npairs + 1, dtype=torch.int32,
                       device=probes.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(
        probes.device).cuda_stream)
    with torch.cuda.device(probes.device):
        err = _library().ivf_scan_plan(
            ctypes.c_void_p(probes.data_ptr()),
            ctypes.c_void_p(plan.data_ptr()), npairs, n_clusters, stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan plan launch failed: cudaError_t {err}")
    plan = plan.cpu().long()
    ng = int(plan[4 * npairs])
    return (plan[:npairs],) + tuple(plan[j * npairs:j * npairs + ng]
                                    for j in (1, 2, 3))


def ivf_scan_topk_fused(probes: torch.Tensor, qp: torch.Tensor,
                        g: torch.Tensor, gn: torch.Tensor, ids: torch.Tensor,
                        *, cap: int, kk: int, marks=None):
    """Fused probed-segment scan + top-kk on the card.

    Args:
      probes: (Nq, nprobe) int32 probed cluster ids (clipped to [0, C)).
      qp: (Nq, k) f32 projected queries.
      g: (C*cap, k) f32 cluster-major segment rows; gn: (C*cap,) f32 row
        norms (+BIG pads); ids: (C*cap,) int32 row ids (-1 pads).
      cap: rows per segment; kk: candidates kept (1 <= kk <= nprobe*cap).
      marks: optional four ``torch.cuda.Event``s, recorded before the
        first plan, after it, after the last scan and after the merge (or
        select), to time the launches apart.

    Returns (dists (Nq, kk) f32, ids (Nq, kk) int32) in (distance,
    candidate position) order; ops.py masks d >= BIG to id -1 and sorts
    by (distance, id).
    """
    device = qp.device
    if device.type != "cuda":
        raise ValueError(f"ivf_scan_topk_fused runs on CUDA tensors, got "
                         f"{device}")
    for name, x, dt, nd in (("probes", probes, torch.int32, 2),
                            ("qp", qp, torch.float32, 2),
                            ("g", g, torch.float32, 2),
                            ("gn", gn, torch.float32, 1),
                            ("ids", ids, torch.int32, 1)):
        check_tensor(name, x, dt, nd, device)
    nq, nprobe = probes.shape
    rows, k = g.shape
    if (qp.shape != (nq, k) or gn.shape[0] != rows or ids.shape[0] != rows
            or cap < 1 or rows % cap):
        raise ValueError(f"shape mismatch: probes {tuple(probes.shape)}, qp "
                         f"{tuple(qp.shape)}, g {tuple(g.shape)}, gn "
                         f"{tuple(gn.shape)}, ids {tuple(ids.shape)}, "
                         f"cap {cap}")
    check_kk(kk, nprobe, cap)
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=device)
    out_i = torch.empty((nq, kk), dtype=torch.int32, device=device)
    if nq == 0:
        return out_d, out_i
    lib = _library()
    npairs = nq * nprobe
    nchunk, rpc = segment_split(cdiv(npairs, GROUP), cap, sm_count(device),
                                TILE_ROWS)
    plan = torch.empty(4 * min(npairs, PLAN_MAX) + 1, dtype=torch.int32,
                       device=device)
    cand_d, cand_p, dump = segment_scratch(nq, nprobe * nchunk, nprobe * cap,
                                           kk, LIST_K, device)
    vec4 = int(k % 4 == 0 and g.data_ptr() % 16 == 0
               and qp.data_ptr() % 16 == 0)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (probes, qp, g, gn, ids, plan, cand_d, cand_p, dump, out_d,
             out_i)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = lib.ivf_scan_launch(*ptrs, nq, nprobe, rows // cap, cap, k, kk,
                                  rpc, nchunk, vec4,
                                  event_handles(marks, 4), stream)
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: cudaError_t "
                           f"{err}")
    ivf_scan_topk_fused.launches += 1
    return out_d, out_i


ivf_scan_topk_fused.launches = 0
