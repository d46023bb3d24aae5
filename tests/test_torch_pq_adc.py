"""The port's pq_adc (repro_torch) held against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's ``pq_adc_topk`` runs the kernel's plain version,
which must be **bit-identical** to the reference's XLA path
(``use_kernel=False``): the subspace sum runs in the same sequential
order and candidates flatten in the same probe-major / slot-minor
order, so distances and ids are equal arrays, not merely close. (The
reference's interpret-mode kernel is red on this tree, ROADMAP Queue 3,
so the port is not held against it.) The CUDA kernel is checked
against its plain version with ``torch.equal`` in
tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.pq_adc import pq_adc_topk as jax_pq_adc_topk

from repro_torch.kernels._dispatch import BIG
from repro_torch.kernels.pq_adc import (pq_adc_topk, pq_adc_topk_fused,
                                        pq_adc_topk_ref)
from repro_torch.kernels.pq_adc.kernel import (LIST_K, PIECE_ROWS,
                                               SMEM_LIMIT, lut_plan,
                                               smem_bytes, unit_plan)


def _case(seed, Nq, C, cap, S, bits, nprobe, fill_lo, fill_hi, ties=False):
    """(tables, dc, probes, codes, t, ids) numpy arrays in the IVFPQ
    segment layout; ``ties`` draws codes from two values and t from a
    small integer grid, so many candidates tie exactly."""
    rng = np.random.RandomState(seed)
    K = 1 << bits
    fills = rng.randint(fill_lo, fill_hi + 1, size=C)
    ids = np.full((C, cap), -1, np.int32)
    codes = np.zeros((C, cap, S), np.uint8)
    t = np.full((C, cap), BIG, np.float32)
    nid = 0
    for c in range(C):
        n = fills[c]
        ids[c, :n] = np.arange(nid, nid + n)
        nid += n
        codes[c, :n] = rng.randint(0, 2 if ties else K, (n, S))
        t[c, :n] = (rng.randint(0, 3, n) if ties else rng.randn(n))
    tables = rng.randn(Nq, S * K).astype(np.float32)
    if ties:
        tables = np.round(tables * 4) / 4
    dc = np.abs(rng.randn(Nq, nprobe)).astype(np.float32)
    probes = np.stack([rng.choice(C, nprobe, replace=False)
                       for _ in range(Nq)]).astype(np.int32)
    return tables, dc, probes, codes, t.astype(np.float32), ids


def _torch(arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _assert_bit_identical(arrays, kk, **kw):
    d_j, i_j = jax_pq_adc_topk(*map(jnp.asarray, arrays), kk=kk,
                               use_kernel=False, **kw)
    d, i = pq_adc_topk(*_torch(arrays), kk=kk, **kw)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    return d, i


# (Nq, C, cap, S, bits, nprobe, kk, fill_lo, fill_hi): the reference's
# PQ_CASES plus kk = 1, S = 100 at 8 bits and kk at the kernel's limit
CASES = [
    (5, 6, 32, 4, 8, 3, 7, 32, 32),      # multi-tile segments, full fill
    (3, 5, 24, 3, 8, 2, 5, 10, 24),      # cap not a multiple of the tile
    (4, 7, 16, 2, 8, 2, 32, 0, 5),       # kk > real rows: -1s surface
    (3, 4, 16, 5, 1, 2, 6, 8, 16),       # 1-bit codes
    (3, 4, 16, 5, 2, 2, 6, 8, 16),       # 2-bit codes
    (2, 4, 8, 3, 4, 3, 24, 2, 8),        # kk == the pool, odd S
    (6, 9, 40, 7, 8, 4, 1, 5, 40),       # kk = 1
    (2, 6, 24, 100, 8, 3, 50, 10, 24),   # the serving S, K
    (2, 8, 40, 6, 8, 8, 256, 30, 40),    # kk at the widest shared list
    (2, 8, 40, 6, 8, 8, 257, 30, 40),    # kk past it: the wide path
    (2, 9, 120, 5, 8, 9, 1024, 60, 120), # the wide path, -1s surface
    (2, 5, 40, 200, 8, 3, 50, 20, 40),   # S 200: the table in chunks
]


@pytest.mark.parametrize("Nq,C,cap,S,bits,nprobe,kk,lo,hi", CASES)
def test_plain_bit_identical_to_reference(Nq, C, cap, S, bits, nprobe, kk,
                                          lo, hi):
    d, i = _assert_bit_identical(
        _case(0, Nq, C, cap, S, bits, nprobe, lo, hi), kk, block_q=2)
    if hi < 8:
        assert bool((i == -1).any()) and bool((d[i == -1] >= BIG).all())


def test_exact_ties_bit_identical_and_smallest_id_first():
    arrays = _case(3, 6, 7, 24, 3, 2, 4, 20, 24, ties=True)
    d, i = _assert_bit_identical(arrays, 15)
    tied = d[:, 1:] == d[:, :-1]
    assert int(tied.sum()) > 5
    assert bool((i[:, 1:] > i[:, :-1])[tied].all())


def test_sum_is_sequential_not_a_reduction():
    # magnitudes chosen so a tree sum rounds differently from the
    # left-to-right sum; the plain version must give the sequential one
    S, K = 3, 2
    tables = torch.tensor([[1e8, 0.0, 1.0, 0.0, -1e8, 0.0]])
    codes = torch.zeros((1, 1, S), dtype=torch.uint8)
    d, _ = pq_adc_topk_ref(tables, torch.zeros((1, 1)),
                           torch.zeros((1, 1), dtype=torch.int32), codes,
                           torch.full((1, 1), 1e9),
                           torch.zeros((1, 1), dtype=torch.int32), 1)
    ip = (np.float32(1e8) + np.float32(1.0)) + np.float32(-1e8)
    assert d.item() == np.float32(1e9) - np.float32(2.0) * ip


def test_exact_ties_on_the_wide_path():
    arrays = _case(4, 3, 8, 100, 3, 2, 5, 60, 100, ties=True)
    d, i = _assert_bit_identical(arrays, 300)
    tied = d[:, 1:] == d[:, :-1]
    real = (i[:, 1:] >= 0) & (i[:, :-1] >= 0)
    assert int((tied & real).sum()) > 5
    assert bool((i[:, 1:] > i[:, :-1])[tied & real].all())


def test_rejects_bad_kk_with_the_reference_messages():
    arrays = _case(1, 2, 4, 8, 2, 4, 2, 8, 8)
    for kk in (0, -3, 2 * 8 + 1):
        with pytest.raises(ValueError, match="kk") as mine:
            pq_adc_topk(*_torch(arrays), kk=kk)
        with pytest.raises(ValueError, match="kk") as ref:
            jax_pq_adc_topk(*map(jnp.asarray, arrays), kk=kk)
        assert str(mine.value) == str(ref.value)


def test_fused_wrapper_needs_cuda_tensors():
    tables, dc, probes, codes, t, ids = _torch(
        _case(0, 2, 3, 8, 4, 8, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc_topk_fused(probes, tables, dc, codes.reshape(24, 4),
                          t.reshape(24), ids.reshape(24), n_codes=256, cap=8,
                          kk=3)


def test_shared_memory_plan_and_refusal():
    # the serving shape: a 102,400-byte table beside two tiles of two
    # 256-row pieces needs the opt-in above 48 KB and fits one block an SM
    assert 48 * 1024 < smem_bytes(100, 256, 50) <= SMEM_LIMIT
    assert lut_plan(100, 256, 50) == (100, 2)
    assert lut_plan(100, 256, 256) == (100, 2)  # the whole table, two tiles
    # S 128: the whole table fits beside one tile, not two
    assert lut_plan(128, 256, 50) == (128, 1)
    assert smem_bytes(128, 256, 50, 128, 2) > SMEM_LIMIT
    # a 204,800-byte table + whole-row tiles does not fit: the plan takes
    # the table in chunks of subspaces instead of refusing
    assert smem_bytes(200, 256, 10, 200, 1) > SMEM_LIMIT
    sc, nstage = lut_plan(200, 256, 10)
    assert 1 <= sc < 200 and nstage == 1
    assert smem_bytes(200, 256, 10, sc) <= SMEM_LIMIT
    assert smem_bytes(200, 256, 10, sc + 1) > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        lut_plan(1, 1 << 16, 10)           # not one subspace of 64K floats


@pytest.mark.parametrize("S", [1, 4, 100, 128, 146, 200, 500, 1000])
@pytest.mark.parametrize("kk", [1, 50, LIST_K, LIST_K + 1, 1024])
def test_chunked_plan_fits_every_subspace_count(S, kk):
    """Every (S, K, kk) the reference computes at d_out <= 1000 with
    8-bit codes fits one block: the whole table beside two code tiles,
    else beside one, else a chunk of the most subspaces that fit; the
    wide path (kk > LIST_K) keeps no lists."""
    sc, nstage = lut_plan(S, 256, kk)
    assert 1 <= sc <= S and nstage in (1, 2)
    assert smem_bytes(S, 256, kk, sc, nstage) <= SMEM_LIMIT
    if nstage == 1 and sc == S:
        assert smem_bytes(S, 256, kk, S, 2) > SMEM_LIMIT
    if sc < S:
        assert smem_bytes(S, 256, kk, S, 1) > SMEM_LIMIT
        assert smem_bytes(S, 256, kk, sc + 1) > SMEM_LIMIT
    lists = 12 * kk * 8 if kk <= LIST_K else 0
    assert smem_bytes(S, 256, kk, 1, 1) == (
        (1024 + 2 * 256 if S > 1 else 1024 + 2 * 272) + lists)


@pytest.mark.parametrize("nq,nprobe,cap", [(1, 16, 1224), (64, 16, 1224),
                                           (3, 2, 24), (1, 1, 7),
                                           (512, 16, 1224), (2, 1024, 33),
                                           (7, 5, 300)])
def test_unit_plan_covers_each_piece_once(nq, nprobe, cap):
    """A query's pieces (a probe's chunk of 256 rows) dealt out in units
    of ppb: each piece in exactly one block, units of whole tiles (two
    pieces) but the last, and about 4 waves of 132 blocks when there are
    enough pieces."""
    ppb, nunits = unit_plan(nq, nprobe, cap, 132)
    npieces = nprobe * -(-cap // PIECE_ROWS)
    assert 1 <= ppb <= npieces and nunits == -(-npieces // ppb)
    pieces = [j for u in range(nunits)
              for j in range(u * ppb, min(npieces, (u + 1) * ppb))]
    assert pieces == list(range(npieces))
    assert ppb == 1 or ppb % 2 == 0 or ppb == npieces
    if nq * npieces >= 8 * 132:
        assert nq * nunits >= 2 * 132          # the card stays full
    else:
        assert ppb <= 2                        # small batches: small units


def test_s200_plain_bit_identical_at_the_eval_width():
    """S = 200 (d_out 1000 in 5-dimensional subspaces), the shape whose
    table the kernel now takes in chunks: the plain path against the
    reference's XLA path, bit for bit, at kk 50 and the wide kk 512."""
    arrays = _case(5, 3, 6, 300, 200, 8, 4, 200, 300)
    for kk in (50, 512):
        _assert_bit_identical(arrays, kk, block_q=2)
