"""The port's SSD chunk scan and Mamba2 layer held against the JAX
reference.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its Pallas kernel in interpret mode (its default) and its
sequential oracle; the port runs its sequential oracle (``ssd_scan_ref``)
and the plain chunked version of its CUDA kernel (``ssd_scan_chunked``,
chunks of 64), which is what ``ssd_core`` takes on the CPU. Tolerance:
rtol = atol = 1e-4 on y and h in f32, the reference's own bound for its
kernel against its oracle (the chunked forms sum in another order than
the recurrence). The Mamba2 layer: the port's three forms against the
reference's on reduced zamba2 in f32, rtol 2e-3 / atol 2e-4 where the
two sides take different SSD forms (the reference's bound between its
kernel path and its chunked form), 1e-4 where they take the same form.
``ssd_scan_segmented``, the card kernel's order of work (a state pass
per segment of whole chunks, the combine, the scan from each segment's
start state), is held to the reference's oracle and its interpret-mode
kernel at the same rtol = atol = 1e-4 across segment edges, and
``segment_plan`` to its contract. The CUDA kernel itself is checked in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.ssd_chunk import ssd_core as jax_ssd_core
from repro.kernels.ssd_chunk import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_chunk import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import mamba2 as jax_mamba2

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_chunk import (CHUNK, segment_plan, ssd_core,
                                           ssd_scan, ssd_scan_chunked,
                                           ssd_scan_ref, ssd_scan_segmented)
from repro_torch.kernels.ssd_chunk.kernel import TARGET_BLOCKS
from repro_torch.models import mamba2

SHAPES = [(4, 64, 16, 8, 16), (2, 128, 64, 64, 32), (8, 96, 32, 16, 48),
          (1, 256, 64, 64, 128), (3, 32, 8, 8, 32)]


def _panes(G, T, p, n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(G, T, p).astype(dtype), rng.randn(G, T, n).astype(dtype),
            rng.randn(G, T, n).astype(dtype),
            (np.abs(rng.randn(G, T)) * 0.1).astype(np.float32),
            (-np.abs(rng.randn(G, T)) * 0.5).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("G,T,p,n,Q", SHAPES)
def test_plain_versions_match_reference(G, T, p, n, Q):
    args = _panes(G, T, p, n, G + T)
    yr, hr = jax_ssd_scan_ref(*map(jnp.asarray, args))
    yk, hk = jax_ssd_scan(*map(jnp.asarray, args), chunk=Q)
    for fn in (ssd_scan_ref, ssd_scan_chunked):
        y, h = fn(*_t(*args))
        assert y.dtype == torch.float32 and h.shape == (G, p, n)
        _close(y, yr)
        _close(h, hr)
        _close(y, yk)
        _close(h, hk)


@pytest.mark.parametrize("T", [1, 63, 65, 100, 200])
def test_ragged_length_matches_reference(T):
    """T off the 64-step chunk: the plain chunked version zero-pads the
    last chunk, which must change nothing."""
    args = _panes(3, T, 16, 8, T)
    yr, hr = jax_ssd_scan_ref(*map(jnp.asarray, args))
    y, h = ssd_scan_chunked(*_t(*args))
    assert y.shape == (3, T, 16)
    _close(y, yr)
    _close(h, hr)


@pytest.mark.parametrize("chunk", [8, 16, CHUNK])
def test_chunk_length_changes_only_rounding(chunk):
    args = _t(*_panes(2, 128, 32, 16, 5))
    y, h = ssd_scan_chunked(*args, chunk=chunk)
    yr, hr = ssd_scan_ref(*args)
    _close(y, yr)
    _close(h, hr)


def test_bf16_inputs():
    """bf16 x, B, C: f32 arithmetic, y back in bf16 (the reference's
    bf16 test bound)."""
    args = _panes(2, 64, 32, 16, 0)
    xs, Bm, Cm = (torch.from_numpy(a).to(torch.bfloat16) for a in args[:3])
    y, _ = ssd_scan_chunked(xs, Bm, Cm, *_t(*args[3:]))
    assert y.dtype == torch.bfloat16
    jx = [jnp.asarray(a, jnp.bfloat16) for a in args[:3]]
    yr, _ = jax_ssd_scan_ref(*jx, *map(jnp.asarray, args[3:]))
    _close(y.float(), np.asarray(yr, np.float32), rtol=5e-2, atol=5e-2)


def test_state_continuity_across_chunks():
    """The final state of two half scans chained equals one full scan."""
    args = _t(*_panes(2, 128, 16, 8, 1))
    _, h_full = ssd_scan_chunked(*args)
    _, h_ref = ssd_scan_ref(*args)
    _close(h_full, h_ref, atol=1e-5)


def test_shared_b_and_c_broadcast_over_heads():
    """B and C of shape (B, 1, T, n) broadcast over the heads exactly as
    an explicit per-head copy."""
    rng = np.random.RandomState(3)
    xs = torch.from_numpy(rng.randn(2, 5, 96, 16).astype(np.float32))
    Bm = torch.from_numpy(rng.randn(2, 1, 96, 8).astype(np.float32))
    Cm = torch.from_numpy(rng.randn(2, 1, 96, 8).astype(np.float32))
    dt = torch.from_numpy((np.abs(rng.randn(2, 5, 96)) * 0.1)
                          .astype(np.float32))
    la = -dt * 2.0
    y1, h1 = ssd_scan_chunked(xs, Bm, Cm, dt, la)
    y2, h2 = ssd_scan_chunked(xs, Bm.expand(2, 5, 96, 8).contiguous(),
                              Cm.expand(2, 5, 96, 8).contiguous(), dt, la)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("B,T,H,p,n", [(2, 64, 4, 16, 8), (1, 100, 3, 32, 16)])
def test_ssd_core_matches_reference(B, T, H, p, n):
    rng = np.random.RandomState(B + T)
    xs = rng.randn(B, T, H, p).astype(np.float32)
    Bm, Cm = (rng.randn(B, T, n).astype(np.float32) for _ in range(2))
    dt = (np.abs(rng.randn(B, T, H)) * 0.1).astype(np.float32)
    la = (-np.abs(rng.randn(B, T, H)) * 0.5).astype(np.float32)
    yr, hr = jax_ssd_core(*map(jnp.asarray, (xs, Bm, Cm, dt, la)), chunk=32)
    y, h = ssd_core(*_t(xs, Bm, Cm, dt, la))
    assert y.shape == (B, T, H, p) and h.shape == (B, H, p, n)
    _close(y, yr)
    _close(h, hr)


# (T, chunks_per_segment): one chunk, ragged single chunks, one segment
# exactly, a segment +- 1 token, a last segment of one partial chunk, and
# 1, 2, 3 and 8 segments
SEGMENTED = [(1, 1), (63, 1), (64, 1), (65, 1), (128, 2), (127, 1),
             (129, 2), (266, 2), (384, 2), (512, 1), (500, 1)]


def _jax_chunk(T):
    """The reference kernel's chunk for T: the largest divisor of T up to
    128 (its wrapper needs T % chunk == 0)."""
    return max(d for d in range(1, 129) if T % d == 0)


@pytest.mark.parametrize("T,cps", SEGMENTED)
def test_segmented_mirror_matches_reference(T, cps):
    """Three heads sharing B and C (a head pair and a single head on the
    card) through the segmented order of work, against the reference's
    oracle and its interpret-mode kernel on the expanded panes; decay slow
    enough that a segment's start state still weighs in."""
    H, p, n = 3, 16, 8
    rng = np.random.RandomState(T + cps)
    xs = rng.randn(1, H, T, p).astype(np.float32)
    Bm, Cm = (rng.randn(1, 1, T, n).astype(np.float32) for _ in range(2))
    dt = (np.abs(rng.randn(1, H, T)) * 0.1).astype(np.float32)
    la = (-np.abs(rng.randn(1, H, T)) * 0.01).astype(np.float32)
    y, h = ssd_scan_segmented(*_t(xs, Bm, Cm, dt, la), cps)
    panes = (xs[0], np.repeat(Bm[0], H, 0), np.repeat(Cm[0], H, 0), dt[0],
             la[0])
    yr, hr = jax_ssd_scan_ref(*map(jnp.asarray, panes))
    yk, hk = jax_ssd_scan(*map(jnp.asarray, panes), chunk=_jax_chunk(T))
    assert y.shape == (1, H, T, p) and h.shape == (1, H, p, n)
    for ref_y, ref_h in ((yr, hr), (yk, hk)):
        _close(y[0], ref_y)
        _close(h[0], ref_h)


@pytest.mark.parametrize("cps", [1, 2, 3])
def test_segmented_mirror_takes_growing_states(cps):
    """la > 0, so exp(W_t - W_s) exceeds 1 below the diagonal and the
    combine multiplies by more than 1: the mirror against the reference's
    oracle and its interpret-mode kernel, T = 300 over 2 to 5 segments."""
    H, T, p, n = 3, 300, 16, 8
    rng = np.random.RandomState(cps)
    xs = rng.randn(1, H, T, p).astype(np.float32)
    Bm, Cm = (rng.randn(1, 1, T, n).astype(np.float32) for _ in range(2))
    dt = (np.abs(rng.randn(1, H, T)) * 0.1).astype(np.float32)
    la = (np.abs(rng.randn(1, H, T)) * 0.005).astype(np.float32)
    y, h = ssd_scan_segmented(*_t(xs, Bm, Cm, dt, la), cps)
    panes = (xs[0], np.repeat(Bm[0], H, 0), np.repeat(Cm[0], H, 0), dt[0],
             la[0])
    yr, hr = jax_ssd_scan_ref(*map(jnp.asarray, panes))
    yk, hk = jax_ssd_scan(*map(jnp.asarray, panes), chunk=_jax_chunk(T))
    for ref_y, ref_h in ((yr, hr), (yk, hk)):
        _close(y[0], ref_y)
        _close(h[0], ref_h)


@pytest.mark.parametrize("cps", [1, 2, 3])
def test_segmented_mirror_follows_the_chunked_scan(cps):
    """More segments change only the rounding: the segmented order of
    work against the one-segment chunked scan at slow decay, where the
    combined start states carry most of the state."""
    args = _t(*_panes(4, 640, 16, 8, cps))
    args[4] = args[4] * 0.02
    y, h = ssd_scan_segmented(*args, cps)
    y1, h1 = ssd_scan_chunked(*args)
    _close(y, y1)
    _close(h, h1)


@pytest.mark.parametrize("B,H,T", [(4, 80, 8192), (1, 80, 8192),
                                   (2, 80, 8192), (1, 4, 64), (2, 80, 1000),
                                   (1, 3, 200), (1, 1, 8192), (2, 4, 100),
                                   (1, 3, 1), (64, 80, 8192),
                                   (1, 5, 4096), (16, 5, 4096),
                                   (1, 40, 4096), (8, 40, 4096)])
@pytest.mark.parametrize("shared", [True, False])
def test_segment_plan_covers_t(B, H, T, shared):
    cps, hpb, grid = segment_plan(B, H, T, shared)
    segs, groups, bsz = grid
    chunks = -(-T // CHUNK)
    assert hpb == (2 if shared else 1)
    assert groups == -(-H // hpb) and bsz == B
    assert 1 <= segs <= 32 and cps >= 1
    assert (segs - 1) * cps < chunks <= segs * cps      # T covered exactly
    assert segs == 1 or cps >= 4                        # no tiny segments


def test_segment_plan_fills_the_card_at_the_service_shape():
    """zamba2's service shape (B 4, T 8192, 80 heads) gets several
    segments and at least the aimed block count; short inputs and large
    batches collapse to one segment."""
    cps, hpb, (segs, groups, bsz) = segment_plan(4, 80, 8192)
    assert segs > 1 and segs * groups * bsz >= TARGET_BLOCKS >= 4 * 132
    assert segment_plan(1, 4, 64)[2][0] == 1
    assert segment_plan(64, 80, 8192)[2][0] == 1


def test_segment_plan_of_a_ranks_heads():
    """zamba2's heads on one rank: 5 on a model axis of 16 (two pairs and
    a lone head, 3 blocks) and 40 on 2 (20); at B 1, T 4,096 (64 chunks)
    both are cut into 16 segments of 4 chunks, the most the chunks
    allow; at B 16 the blocks of the batch leave fewer to fill."""
    assert segment_plan(1, 5, 4096) == (4, 2, (16, 3, 1))
    assert segment_plan(1, 40, 4096) == (4, 2, (16, 20, 1))
    assert segment_plan(16, 5, 4096) == (6, 2, (11, 3, 16))
    assert segment_plan(16, 40, 4096) == (32, 2, (2, 20, 16))


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _t(*_panes(2, 64, 16, 8, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(*args)


# -- the Mamba2 layer ---------------------------------------------------------

def _layer_cfgs():
    over = dict(dtype="float32", ssm_tile_dtype="float32", ssm_chunk=32)
    return (jax_reduced(jax_get_config("zamba2-2.7b")).replace(**over),
            get_config("zamba2-2.7b-reduced").replace(**over))


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = _layer_cfgs()
    jp = jax_mamba2.init_mamba2(jcfg, jax.random.PRNGKey(0))
    p = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in jp.items()}
    x = np.random.RandomState(0).randn(2, 64, cfg.d_model).astype(np.float32)
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("form,jax_form,tol", [
    ("apply_mamba2", "apply_mamba2", (1e-4, 1e-4)),
    ("apply_mamba2_kernel", "apply_mamba2_kernel", (1e-4, 1e-4)),
    ("apply_mamba2_ref", "apply_mamba2_ref", (1e-4, 1e-4)),
    ("apply_mamba2_kernel", "apply_mamba2", (2e-3, 2e-4)),
    ("apply_mamba2_ref", "apply_mamba2", (2e-3, 2e-4)),
])
def test_mamba2_layer_matches_reference(layer, form, jax_form, tol):
    jcfg, cfg, jp, p, x = layer
    kw = {"chunk": 16} if jax_form == "apply_mamba2_kernel" else {}
    ref = getattr(jax_mamba2, jax_form)(jp, jnp.asarray(x), jcfg, **kw)
    out = getattr(mamba2, form)(p, torch.from_numpy(x), cfg)
    assert out.shape == x.shape
    _close(out, ref, rtol=tol[0], atol=tol[1])


def test_mamba2_bf16_tiles_follow_the_reference(layer):
    """The plain chunked form with bf16 tiles (zamba2's own setting)
    stays within the reference's bf16 tolerance of the f32 recurrence."""
    jcfg, cfg, jp, p, x = layer
    out = mamba2.apply_mamba2(p, torch.from_numpy(x),
                              cfg.replace(ssm_tile_dtype="bfloat16"))
    ref = jax_mamba2.apply_mamba2_ref(jp, jnp.asarray(x), jcfg)
    _close(out, ref, rtol=5e-2, atol=5e-2)


def test_causal_conv_is_the_shifted_sum():
    rng = np.random.RandomState(2)
    x, w, b = (rng.randn(2, 9, 5).astype(np.float32),
               rng.randn(4, 5).astype(np.float32),
               rng.randn(5).astype(np.float32))
    ref = jax_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b))
    out = mamba2._causal_conv(*_t(x, w, b))
    _close(out, ref, rtol=1e-6, atol=1e-6)
