"""The port's attention held against the JAX reference: the flash
attention kernel's plain version and the model's attention forms.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its oracle (``attention_ref``) and its Pallas kernel in
interpret mode; the port runs ``attention_ref``, the plain version
the CUDA kernel is held against. Tolerance in f32: rtol 1e-4, atol
2e-5, the reference's own bound for its kernel against its oracle;
bf16: rtol = atol = 5e-2 (its bf16 bound). The model's naive and
chunked forms must match the reference's within 1e-5. A query slice at
an offset (``q_offset``, context parallelism) is held to the rows of the
reference's oracle on the whole sequence, and the model's split into
rank slices to the reference's ``attend_naive(q_offset=)``, at the f32
bound; the slice against the keys up to its last position to the slice
against every key within rtol 1e-6, atol 1e-7. The CUDA kernel itself
is checked in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jax_attention

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import (BLOCK_Q, SKIP,
                                                        block_k, tile_plan)
from repro_torch.models import attention

from _flash_tile_plan import (EDGE_PLANS, OFFSET_PLANS, PARITY_PLANS,
                              check_plan_against_mask)


def _qkv(B, T, S, H, K, dh, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H, dh).astype(dtype),
            rng.randn(B, S, K, dh).astype(dtype),
            rng.randn(B, S, K, dh).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _close(a, b, rtol=1e-4, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,T,H,K,dh", [
    (2, 128, 4, 4, 64),      # MHA
    (2, 128, 8, 2, 64),      # GQA 4:1
    (1, 256, 4, 1, 32),      # MQA
    (2, 64, 4, 4, 128),
    (2, 128, 6, 2, 80),      # zamba2's head dim, GQA 3:1
    (1, 128, 4, 2, 256),     # gemma-7b's head dim, GQA 2:1
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_reference(B, T, H, K, dh, causal):
    q, k, v = _qkv(B, T, T, H, K, dh, T + H)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    ker = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                    block_q=64, block_k=64)
    out = attention_ref(*_t(q, k, v), causal=causal)
    assert out.shape == (B, T, H, dh) and out.dtype == torch.float32
    _close(out, ref)
    _close(out, ker)


@pytest.mark.parametrize("window", [32, 64, 128, 300])
def test_sliding_window(window):
    q, k, v = _qkv(1, 256, 256, 4, 2, 32, window)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=True,
                            window=window)
    ker = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                    window=window, block_q=64, block_k=64)
    out = attention_ref(*_t(q, k, v), causal=True, window=window)
    _close(out, ref)
    _close(out, ker)


@pytest.mark.parametrize("T,S", [(100, 100), (37, 70), (70, 37)])
def test_ragged_and_rectangular(T, S):
    """T, S off every tile and T != S: the reference's wrapper takes its
    oracle here; the port's plain version must equal it."""
    q, k, v = _qkv(2, T, S, 6, 3, 16, T + S)
    for causal in (True, False):
        ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)),
                                causal=causal, window=50)
        _close(attention_ref(*_t(q, k, v), causal=causal, window=50), ref)


def test_row_blocks_change_nothing():
    q, k, v = _t(*_qkv(1, 130, 130, 4, 2, 16, 9))
    a = attention_ref(q, k, v, causal=True, window=40)
    b = attention_ref(q, k, v, causal=True, window=40, q_block=7)
    assert torch.equal(a, b)


def test_bf16_inputs():
    q, k, v = _qkv(2, 128, 128, 4, 4, 64, 3)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = jax_attention_ref(*jx, causal=True)
    out = attention_ref(*(x.to(torch.bfloat16) for x in _t(q, k, v)),
                        causal=True)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref, np.float32), rtol=5e-2, atol=5e-2)


# (T, H, K, causal, window, offset, rows): MHA, GQA (smollm's 9 heads on
# 3 kv heads), a window, non-causal, offsets on and off the tiles
OFFSET_CASES = [(256, 4, 4, True, 0, 64, 64), (256, 8, 2, True, 0, 100, 77),
                (256, 9, 3, True, 0, 128, 128),
                (256, 4, 2, True, 48, 130, 100),
                (300, 4, 2, True, 64, 236, 64),
                (256, 4, 2, False, 0, 50, 128)]


@pytest.mark.parametrize("T,H,K,causal,window,off,rows", OFFSET_CASES)
def test_plain_version_at_a_query_offset(T, H, K, causal, window, off,
                                         rows):
    """A slice of the queries at their positions (``q_offset``) against
    every key: the rows of the reference's oracle on the whole sequence;
    a causal slice against the keys up to its last position gives the
    same rows (what the kernel skips)."""
    q, k, v = _qkv(2, T, T, H, K, 32, T + off)
    ref = jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                            window=window)
    tq, tk, tv = _t(q, k, v)
    qs = tq[:, off:off + rows]
    out = attention_ref(qs, tk, tv, causal=causal, window=window,
                        q_offset=off)
    _close(out, np.asarray(ref)[:, off:off + rows])
    if causal:
        cut = attention_ref(qs, tk[:, :off + rows], tv[:, :off + rows],
                            causal=True, window=window, q_offset=off)
        _close(cut, out, rtol=1e-6, atol=1e-7)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(*_t(*_qkv(1, 64, 64, 2, 2, 16, 0)))


# -- the bf16 kernel's tile plan ---------------------------------------------

@pytest.mark.parametrize("T,S,causal,window,dh", PARITY_PLANS + EDGE_PLANS)
def test_tile_plan_against_brute_force_mask(T, S, causal, window, dh):
    """The kernel runs no mask in a full tile and never visits a skipped
    one: tile_plan's classification against a numpy mask."""
    check_plan_against_mask(tile_plan(T, S, causal, window, dh), T, S,
                            causal, window, dh)


@pytest.mark.parametrize("T,S,causal,window,dh,q_offset", OFFSET_PLANS)
def test_tile_plan_at_a_query_offset_against_brute_force_mask(
        T, S, causal, window, dh, q_offset):
    """As above for a query slice whose rows start at ``q_offset`` (the
    causal diagonal and the window's edge move right by the offset)."""
    check_plan_against_mask(tile_plan(T, S, causal, window, dh, q_offset),
                            T, S, causal, window, dh, q_offset)


def test_tile_plan_visits_the_band_once():
    """zamba2's service shape: every allowed pair lies in a visited tile,
    and the visited tiles stay within one tile of the band's edges."""
    T, window = 8192, 4096
    plan = tile_plan(T, T, True, window, 80)
    bk = block_k(80)
    band = sum(min(t + 1, window) for t in range(T))
    visited = int((plan != SKIP).sum()) * BLOCK_Q * bk
    assert band <= visited <= band + 3 * T * bk


# -- the model's attention forms ---------------------------------------------

@pytest.mark.parametrize("attn", ["full", "sliding"])
@pytest.mark.parametrize("T,chunk", [(64, 16), (128, 32)])
def test_model_attention_forms_match_reference(attn, T, chunk):
    jcfg = jax_reduced(jax_get_config("smollm-135m")).replace(
        attention=attn, window=40)
    cfg = get_config("smollm-135m-reduced").replace(attention=attn,
                                                    window=40)
    q, k, v = _qkv(2, T, T, 4, 2, 64, T + chunk)
    jq = list(map(jnp.asarray, (q, k, v)))
    tq = _t(q, k, v)
    naive = attention.attend_naive(*tq, cfg)
    _close(naive, jax_attention.attend_naive(*jq, jcfg), rtol=1e-5,
           atol=1e-5)
    chunked = attention.attend_chunked(*tq, cfg, q_chunk=chunk,
                                       kv_chunk=chunk)
    _close(chunked, jax_attention.attend_chunked(*jq, jcfg, q_chunk=chunk,
                                                 kv_chunk=chunk),
           rtol=1e-5, atol=1e-5)
    # the CPU inference path is the plain form; the kernel's plain
    # version computes the same function
    _close(attention.attend(*tq, cfg), naive, rtol=1e-5, atol=1e-5)
    window = 40 if attn == "sliding" else 0
    _close(attention_ref(*tq, causal=True, window=window), naive)


@pytest.mark.parametrize("T,window", [(128, 0), (100, 0), (128, 48)])
def test_model_attend_at_head_dim_256(T, window):
    """gemma-7b's 16 heads of 256 (here 4 heads, GQA 2:1): the port's
    ``attend`` (the plain form on the CPU; the Dh-256 kernel on the card)
    and the kernel's plain version against the reference's ``attend``,
    causal, full and sliding, T off the tiles."""
    attn = "sliding" if window else "full"
    jcfg = jax_get_config("gemma-7b").replace(attention=attn, window=window)
    cfg = get_config("gemma-7b").replace(attention=attn, window=window)
    q, k, v = _qkv(1, T, T, 4, 2, 256, T + window)
    ref = jax_attention.attend(*map(jnp.asarray, (q, k, v)), jcfg)
    tq = _t(q, k, v)
    _close(attention.attend(*tq, cfg), ref, rtol=1e-5, atol=1e-5)
    _close(attention_ref(*tq, causal=True, window=window), ref)


@pytest.mark.parametrize("T,M", [(256, 2), (2560, 2), (2048, 4)])
@pytest.mark.parametrize("attn", ["full", "sliding"])
def test_context_parallel_split_against_attend_naive(T, M, attn):
    """The model's context-parallel split (``_cp_rows``, ``cp_offsets``:
    each of M ranks its slice of every q chunk): every slice through the
    kernel's plain version at its ``q_offset`` against the reference's
    ``attend_naive(q_offset=)`` on the same slice, and the slices put
    back in sequence order against the reference's ``attend``."""
    jcfg = jax_reduced(jax_get_config("smollm-135m")).replace(
        n_heads=9, n_kv_heads=3, attention=attn, window=300,
        attn_q_chunk=512, attn_kv_chunk=512)
    cfg = get_config("smollm-135m-reduced").replace(
        n_heads=9, n_kv_heads=3, attention=attn, window=300,
        attn_q_chunk=512, attn_kv_chunk=512)
    q, k, v = _qkv(1, T, T, 9, 3, 16, T + M)
    cp = attention._cp_rows(T, cfg, M)
    qc, nq, rows = cp
    window = 300 if attn == "sliding" else 0
    full = np.asarray(jax_attention.attend(*map(jnp.asarray, (q, k, v)),
                                           jcfg))
    tq, tk, tv = _t(q, k, v)
    back = np.zeros_like(full)
    for m in range(M):
        for c, off in enumerate(attention.cp_offsets(cp, m)):
            assert off == c * qc + m * rows
            out = attention_ref(tq[:, off:off + rows], tk, tv, causal=True,
                                window=window, q_offset=off)
            want = jax_attention.attend_naive(
                jnp.asarray(q[:, off:off + rows]), jnp.asarray(k),
                jnp.asarray(v), jcfg, q_offset=off)
            _close(out, want)
            back[:, off:off + rows] = out.numpy()
    _close(back, full)


def test_chunked_refuses_ragged_chunks():
    cfg = get_config("smollm-135m-reduced")
    q, k, v = _t(*_qkv(1, 100, 100, 4, 2, 16, 0))
    with pytest.raises(ValueError, match="multiple of the chunks"):
        attention.attend_chunked(q, k, v, cfg, q_chunk=64, kv_chunk=64)
