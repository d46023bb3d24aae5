"""The port's ivf_scan (repro_torch) held against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's ``ivf_scan_topk`` runs the kernel's plain version;
the reference runs its XLA path and its Pallas kernel in interpret mode
(as tests/test_scan_kernels.py does). Ids must be equal and distances
within atol + rtol * (qn + gn), rtol = atol = 1e-5 (f32 on both sides,
different summation order). ``ivf_scan_grouped``, the same function in
the kernel's cluster-major order of work, is held to the same rule
against both, and its work plan (``work_plan``) to the plan's contract:
every (query, probe, chunk) once, groups of at most 8 pairs of one
segment. The CUDA kernel itself is checked against its plain version,
and its own plan against ``work_plan``, in tests/test_torch_cuda.py,
which needs a card. Also here: the wrapper's launch plan and refusals,
and the build helper's source hash (it covers included headers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ivf_scan import ivf_scan_topk as jax_ivf_scan_topk

from repro_torch.kernels import _build
from repro_torch.kernels._dispatch import BIG, cdiv, segment_split
from repro_torch.kernels.ivf_scan import (ivf_scan_grouped, ivf_scan_topk,
                                          ivf_scan_topk_fused,
                                          ivf_scan_topk_ref)
from repro_torch.kernels.ivf_scan.kernel import (GROUP, LIST_K, PLAN_MAX,
                                                 SMEM_LIMIT, TILE_ROWS,
                                                 max_groups, smem_bytes,
                                                 work_plan)

RTOL = ATOL = 1e-5


def _segments(rng, C, cap, fill_lo, fill_hi):
    """Random per-cluster fills (possibly empty segments) + global ids."""
    fills = rng.randint(fill_lo, fill_hi + 1, size=C)
    ids = np.full((C, cap), -1, np.int32)
    nid = 0
    for c in range(C):
        ids[c, :fills[c]] = np.arange(nid, nid + fills[c])
        nid += fills[c]
    return fills, ids


def _case(seed, Nq, C, cap, k, nprobe, fill_lo, fill_hi, dup=False):
    """(qp, probes, g, gn, ids) numpy arrays in the IVF segment layout;
    ``dup`` repeats each segment's first real row through the segment,
    so distances tie exactly."""
    rng = np.random.RandomState(seed)
    fills, ids = _segments(rng, C, cap, fill_lo, fill_hi)
    g = np.zeros((C, cap, k), np.float32)
    gn = np.full((C, cap), BIG, np.float32)
    for c in range(C):
        n = fills[c]
        g[c, :n] = rng.randn(n, k).astype(np.float32)
        if dup and n:
            g[c, :n] = g[c, 0]
        gn[c, :n] = np.sum(g[c, :n] ** 2, axis=1)
    qp = rng.randn(Nq, k).astype(np.float32)
    probes = np.stack([rng.choice(C, nprobe, replace=False)
                       for _ in range(Nq)]).astype(np.int32)
    return qp, probes, g, gn, ids


def _torch(arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


# (Nq, C, cap, k, nprobe, kk, fill_lo, fill_hi): the reference's
# IVF_CASES plus kk = 1, an under-filled pool and a k past one slice
CASES = [
    (5, 6, 32, 12, 3, 7, 32, 32),          # multi-tile, full fill
    (3, 5, 24, 8, 2, 5, 10, 24),           # cap % tile != 0
    (4, 7, 16, 5, 2, 32, 0, 5),            # kk > real segment rows (-1s)
    (2, 4, 8, 130, 3, 24, 2, 8),           # k > one lane, full pool
    (6, 9, 40, 33, 4, 1, 5, 40),           # kk = 1
    (3, 5, 50, 260, 5, 60, 0, 50),         # k past two slices, -1s
    (3, 6, 60, 20, 5, 257, 30, 60),        # kk past the widest list
    (2, 12, 100, 16, 11, 1024, 20, 100),   # the wide path, -1s
]


@pytest.mark.parametrize("Nq,C,cap,k,nprobe,kk,lo,hi", CASES)
def test_plain_matches_reference_xla(Nq, C, cap, k, nprobe, kk, lo, hi):
    arrays = _case(0, Nq, C, cap, k, nprobe, lo, hi)
    d_j, i_j = jax_ivf_scan_topk(*map(jnp.asarray, arrays), kk=kk, block_q=2,
                                 use_kernel=False)
    d, i = ivf_scan_topk(*_torch(arrays), kk=kk, block_q=2)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    qp, _, _, gn, _ = arrays
    tol = ATOL + RTOL * (np.sum(qp ** 2, 1)[:, None] + np.abs(d.numpy()))
    assert (np.abs(d.numpy() - np.asarray(d_j)) <= tol).all()
    if hi < 8:                             # the pool is under-filled
        assert (i.numpy() == -1).any()
        assert (d.numpy()[i.numpy() == -1] >= BIG).all()


@pytest.mark.parametrize("Nq,C,cap,k,nprobe,kk,lo,hi", CASES[:3:2])
def test_plain_matches_reference_interpret_kernel(Nq, C, cap, k, nprobe, kk,
                                                  lo, hi):
    arrays = _case(1, Nq, C, cap, k, nprobe, lo, hi)
    d_j, i_j = jax_ivf_scan_topk(*map(jnp.asarray, arrays), kk=kk, block_q=2,
                                 block_m=8, use_kernel=True, interpret=True)
    d, i = ivf_scan_topk(*_torch(arrays), kk=kk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-4,
                               atol=1e-4)


def test_ties_go_to_the_smaller_id():
    arrays = _case(2, 4, 5, 16, 6, 3, 7, 16, dup=True)
    d_j, i_j = jax_ivf_scan_topk(*map(jnp.asarray, arrays), kk=12,
                                 use_kernel=False)
    d, i = ivf_scan_topk(*_torch(arrays), kk=12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    tied = d[:, 1:] == d[:, :-1]
    assert bool(tied.any())
    assert bool((i[:, 1:] > i[:, :-1])[tied].all())


def test_block_q_chunking_is_invisible():
    arrays = _torch(_case(3, 11, 6, 24, 9, 3, 10, 24))
    a = ivf_scan_topk(*arrays, kk=9, block_q=1)
    b = ivf_scan_topk(*arrays, kk=9, block_q=64)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], rtol=RTOL, atol=ATOL)


def test_ref_clips_out_of_range_probes():
    qp, probes, g, gn, ids = _torch(_case(4, 3, 4, 8, 5, 2, 8, 8))
    clipped = probes.clone()
    probes[:, 0] = 99                   # reads the last segment
    clipped[:, 0] = 3
    a = ivf_scan_topk_ref(qp, probes, g, gn, ids, 4)
    b = ivf_scan_topk_ref(qp, clipped, g, gn, ids, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rejects_bad_kk_with_the_reference_messages():
    arrays = _case(1, 2, 4, 8, 6, 2, 0, 8)
    for kk in (0, -3, 2 * 8 + 1):
        with pytest.raises(ValueError, match="kk") as mine:
            ivf_scan_topk(*_torch(arrays), kk=kk)
        with pytest.raises(ValueError, match="kk") as ref:
            jax_ivf_scan_topk(*map(jnp.asarray, arrays), kk=kk)
        assert str(mine.value) == str(ref.value)


def test_fused_wrapper_needs_cuda_tensors():
    qp, probes, g, gn, ids = _torch(_case(0, 2, 3, 8, 4, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ivf_scan_topk_fused(probes, qp, g.reshape(24, 4), gn.reshape(24),
                            ids.reshape(24), cap=8, kk=3)


@pytest.mark.parametrize("nq,nprobe,cap", [(1, 16, 1224), (64, 16, 1224),
                                           (3, 2, 24), (1, 1, 7),
                                           (512, 16, 1224), (2, 1024, 33)])
def test_split_plan_covers_each_segment(nq, nprobe, cap):
    """ivf_scan's scan has at least ceil(nq * nprobe / 8) blocks before
    splitting (groups of 8 pairs); a segment is cut into chunks of whole
    tiles only when they would not fill 4 waves of 132 SMs."""
    units = cdiv(nq * nprobe, GROUP)
    nchunk, rows = segment_split(units, cap, 132, TILE_ROWS)
    assert rows % TILE_ROWS == 0 and nchunk >= 1
    assert (nchunk - 1) * rows < cap <= nchunk * rows
    if units >= 4 * 132:
        assert nchunk == 1              # enough blocks without chunks
    else:
        assert units * nchunk >= min(4 * 132 // 2,
                                     units * -(-cap // TILE_ROWS))


def _probes_of(mode, Nq, C, nprobe, seed=0):
    """(Nq, nprobe) int32 probes: "distinct" clusters a row, "skewed"
    (every row the same clusters: one hot segment a group), "repeat" (ids
    repeated in a row and out of range, so clipping makes more repeats)."""
    rng = np.random.RandomState(seed)
    if mode == "skewed":
        pr = np.tile(rng.choice(C, nprobe, replace=False), (Nq, 1))
    elif mode == "repeat":
        pr = rng.randint(-3, C + 3, (Nq, nprobe))
        pr[:, 1] = pr[:, 0]
    else:
        pr = np.stack([rng.choice(C, nprobe, replace=False)
                       for _ in range(Nq)])
    return torch.tensor(pr, dtype=torch.int32)


# (probes, Nq, C, nprobe): duplicates after clipping, one hot segment
# probed by every query, Nq 1, Nq * nprobe not a multiple of 8, more pairs
# than one plan launch takes
PLAN_CASES = [("repeat", 5, 6, 7), ("repeat", 64, 3, 16),
              ("skewed", 64, 1024, 16), ("skewed", 64, 40, 1),
              ("distinct", 1, 1024, 16), ("distinct", 1, 5, 3),
              ("distinct", 3, 9, 5), ("distinct", 700, 1024, 16)]


@pytest.mark.parametrize("mode,Nq,C,nprobe", PLAN_CASES)
def test_work_plan_covers_each_pair_once_in_groups_of_one_segment(
        mode, Nq, C, nprobe):
    probes = _probes_of(mode, Nq, C, nprobe)
    seg = probes.reshape(-1).long().clamp(0, C - 1)
    seen = []
    rounds = work_plan(probes, C)
    assert len(rounds) == cdiv(Nq * nprobe, PLAN_MAX)
    for pair0, order, gfirst, gcount, gseg in rounds:
        npairs = order.numel()
        assert len(gfirst) <= max_groups(npairs, C)
        # order: the round's pairs sorted by (segment, pair), stably
        key = seg[order] * (Nq * nprobe) + order
        assert bool((key[1:] > key[:-1]).all())
        assert sorted(order.tolist()) == list(range(pair0, pair0 + npairs))
        assert int(gcount.sum()) == npairs
        assert bool((gcount >= 1).all() and (gcount <= GROUP).all())
        for f, n, s in zip(gfirst.tolist(), gcount.tolist(), gseg.tolist()):
            pairs = order[f:f + n]
            assert bool((seg[pairs] == s).all())      # one segment a group
            # groups are cut from the start of their segment's run
            assert int((seg[order[:f]] == s).sum()) % GROUP == 0
            seen += pairs.tolist()
    assert sorted(seen) == list(range(Nq * nprobe))   # each pair once
    # a hot segment probed by every query: groups of 8, and the count
    # the grid's bound allows
    if mode == "skewed":
        assert len(rounds[0][2]) == nprobe * cdiv(Nq, GROUP)


@pytest.mark.parametrize("mode,Nq,C,nprobe", PLAN_CASES[:6])
def test_blocks_cover_each_query_probe_chunk_once(mode, Nq, C, nprobe):
    """The scan's blocks, one per (group, chunk), with each group's pairs,
    cover every (query, probe, chunk) exactly once: the candidate-list
    slots the merge reads."""
    cap = 300
    probes = _probes_of(mode, Nq, C, nprobe)
    nchunk, _ = segment_split(cdiv(Nq * nprobe, GROUP), cap, 132, TILE_ROWS)
    slots = []
    for _, order, gfirst, gcount, _ in work_plan(probes, C):
        for f, n in zip(gfirst.tolist(), gcount.tolist()):
            for c in range(nchunk):
                slots += [p * nchunk + c for p in order[f:f + n].tolist()]
    assert sorted(slots) == list(range(Nq * nprobe * nchunk))


def test_max_groups_bounds_every_plan():
    rng = np.random.RandomState(3)
    for _ in range(40):
        Nq, nprobe, C = rng.randint(1, 40), rng.randint(1, 20), \
            rng.randint(1, 60)
        probes = torch.tensor(rng.randint(0, C, (Nq, nprobe)),
                              dtype=torch.int32)
        (_, _, gfirst, _, _), = work_plan(probes, C)
        assert len(gfirst) <= max_groups(Nq * nprobe, C) <= Nq * nprobe


@pytest.mark.parametrize("Nq,C,cap,k,nprobe,kk,lo,hi", CASES)
def test_grouped_mirror_matches_reference_xla(Nq, C, cap, k, nprobe, kk, lo,
                                              hi):
    arrays = _case(5, Nq, C, cap, k, nprobe, lo, hi)
    d_j, i_j = jax_ivf_scan_topk(*map(jnp.asarray, arrays), kk=kk,
                                 use_kernel=False)
    d, i = ivf_scan_grouped(*_torch(arrays), kk=kk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    qp = arrays[0]
    tol = ATOL + RTOL * (np.sum(qp ** 2, 1)[:, None] + np.abs(d.numpy()))
    assert (np.abs(d.numpy() - np.asarray(d_j)) <= tol).all()


@pytest.mark.parametrize("Nq,C,cap,k,nprobe,kk,lo,hi", CASES[:3:2])
def test_grouped_mirror_matches_reference_interpret_kernel(
        Nq, C, cap, k, nprobe, kk, lo, hi):
    arrays = _case(6, Nq, C, cap, k, nprobe, lo, hi)
    d_j, i_j = jax_ivf_scan_topk(*map(jnp.asarray, arrays), kk=kk, block_q=2,
                                 block_m=8, use_kernel=True, interpret=True)
    d, i = ivf_scan_grouped(*_torch(arrays), kk=kk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode,Nq,C,cap,k,nprobe,kk", [
    ("skewed", 64, 12, 40, 9, 4, 10), ("skewed", 20, 30, 24, 5, 6, 100),
    ("repeat", 9, 8, 30, 12, 6, 20), ("repeat", 3, 5, 16, 7, 5, 80),
    ("distinct", 1, 20, 300, 16, 16, 10), ("distinct", 1, 20, 300, 16, 16,
                                           257)])
def test_grouped_mirror_matches_plain_version(mode, Nq, C, cap, k, nprobe,
                                              kk):
    """Skewed and repeated probes, and Nq 1 (a segment split into 32-row
    chunks): the grouped order of work gives the plain version's ids and
    its distances to f32 rounding; with repeated probes, both keep an id
    twice where a row scans its cluster twice."""
    qp, _, g, gn, ids = _torch(_case(7, Nq, C, cap, k, nprobe, cap // 2,
                                     cap))
    probes = _probes_of(mode, Nq, C, nprobe)
    d, i = ivf_scan_grouped(qp, probes, g, gn, ids, kk)
    dp, ip = ivf_scan_topk_ref(qp, probes, g, gn, ids, kk)
    assert torch.equal(i, ip)
    tol = ATOL + RTOL * (torch.sum(qp ** 2, 1)[:, None] + dp.abs())
    assert bool(((d - dp).abs() <= tol).all())


def test_shared_memory_plan():
    """A scan block's shared memory fits the card for every kk (lists of
    up to LIST_K; wider kk keeps none) and does not grow with k: the
    query rows stream through the stages beside the segment's."""
    stages = 3 * (TILE_ROWS + GROUP) * 128 * 4 + 4 * GROUP * TILE_ROWS
    for kk in range(1, 2 * LIST_K):
        assert smem_bytes(kk) <= SMEM_LIMIT
        assert smem_bytes(kk) == stages + (GROUP * kk * 8 if kk <= LIST_K
                                           else 0)
    assert smem_bytes(100_000) == stages
    assert smem_bytes(LIST_K) < 96 * 1024     # two blocks an SM


def test_build_hash_covers_included_headers(tmp_path):
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    head = tmp_path / "inc" / "h.cuh"
    deep = tmp_path / "inc" / "deep.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/h.cuh"\n')
    head.write_text('#pragma once\n#include "deep.cuh"\n')
    deep.write_text("// v1\n")
    first = _build._target(src)
    assert _build._target(src) == first           # stable
    deep.write_text("// v2\n")                    # nested header edited
    second = _build._target(src)
    assert second != first
    head.write_text('#pragma once\n#include "deep.cuh"\n// edit\n')
    assert _build._target(src) not in (first, second)
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert [p.name for p in _build._sources_of(src)] == [
        "k.cu", "h.cuh", "deep.cuh"]


def test_every_kernel_source_is_found():
    names = {p.stem for p in _build.all_sources()}
    assert {"ivf_scan", "pq_adc", "metric_topk", "dml_pair",
            "pairwise_dist"} <= names
    for src in _build.all_sources():
        if src.stem in ("ivf_scan", "pq_adc"):     # share topk_list.cuh
            assert [p.name for p in _build._sources_of(src)][1:] == [
                "topk_list.cuh"]
