"""The port's rwkv6 family held against the JAX reference's.

One numpy seed feeds both packages; the reference's parameters
(``init_rwkv6`` / ``Model.init`` from a PRNG key) come across as numpy
arrays (``convert.model_params_from_jax`` for whole models).
``rwkv6-1.6b-reduced``: d_model 256, 4 heads of 64, 2 layers, vocab 512,
f32. Head size 64 and chunk 32 are the full config's, so the chunked
form's exponent range here equals the full width's.

Tolerances. Port against reference on the same form (``_mix_heads``,
``_group_norm``, the chunked ``apply_rwkv6``, ``apply_rwkv6_ref``,
``decode_step``, the channel mix, ``Model``): the same operations in
the same order of casts, only the summation order of the products
differs: rtol 1e-4, atol 1e-5 (the port's ``SAME_TOL``). The chunked
form against the token-by-token recurrence in the port: rtol 1e-3, atol
1e-4 (the reference's own bound, ``test_model_internals.py``
``TestRWKV6``). Gradients at the decay clamp: max |a - b| within 1e-3 of
the leaf's largest |b| (the chunked form's rtol against the
recurrence, scaled by the leaf, since u's and the mixes' gradients are
sums that cancel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import mlp as jax_mlp
from repro.models import rwkv6 as jax_rwkv6

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import Model, mlp, rwkv6

SAME_TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_REL = 1e-3
JCFG = jax_reduced(jax_get_config("rwkv6-1.6b")).replace(dtype="float32")
CFG = get_config("rwkv6-1.6b-reduced").replace(dtype="float32")
B, T = 2, 64


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _layer(seed=0, w0=None):
    """The reference's time-mix params and the same as tensors; ``w0``
    fills every w0 (+2 pushes every decay to its clamp of -5)."""
    jp = jax_rwkv6.init_rwkv6(JCFG, jax.random.PRNGKey(seed))
    if w0 is not None:
        jp = dict(jp, w0=jnp.full_like(jp["w0"], w0))
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(seed=0, n=T, scale=0.5):
    return (scale * np.random.RandomState(seed).randn(
        B, n, CFG.d_model)).astype(np.float32)


# -- the time mix -----------------------------------------------------------------

def test_config_and_init_match_reference():
    assert (CFG.d_model, CFG.n_heads, CFG.dim_per_head, CFG.n_layers,
            CFG.vocab_size) == (256, 4, 64, 2, 512)
    jp, _ = _layer()
    p = rwkv6.init_rwkv6(CFG, torch.Generator().manual_seed(0))
    assert list(p) == list(jp)
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == \
            torch.float32, k
    assert p["w_lora_a"].shape[1] == max(32, CFG.d_model // 32)
    assert float(p["w0"].mean()) < -5.5        # decays near 0 at init
    jc = jax_mlp.init_mlp(JCFG, jax.random.PRNGKey(0))
    c = mlp.init_mlp(CFG, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: v.shape for k, v in jc.items()}


def test_mix_heads_matches_reference():
    jp, p = _layer(1)
    x = _x(1, n=16)
    prev = _x(2, n=1)[:, 0]
    ref = jax_rwkv6._mix_heads(jp, jnp.asarray(x), jnp.asarray(prev), JCFG)
    out = rwkv6._mix_heads(p, torch.from_numpy(x), torch.from_numpy(prev),
                           CFG)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        _close(a, b, **SAME_TOL)


def test_group_norm_matches_reference():
    rng = np.random.RandomState(3)
    y = (3.0 * rng.randn(B, 5, CFG.n_heads, CFG.dim_per_head) + 1.0).astype(
        np.float32)
    scale = rng.rand(CFG.d_model).astype(np.float32)
    ref = jax_rwkv6._group_norm(jnp.asarray(y), jnp.asarray(scale), JCFG)
    out = rwkv6._group_norm(torch.from_numpy(y), torch.from_numpy(scale),
                            CFG)
    assert tuple(out.shape) == ref.shape == (B, 5, CFG.d_model)
    _close(out, ref, **SAME_TOL)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("with_prev", [False, True])
def test_apply_rwkv6_matches_reference(chunk, with_prev):
    jp, p = _layer(2)
    x = _x(3)
    prev = _x(4, n=1)[:, 0] if with_prev else None
    ref = jax_rwkv6.apply_rwkv6(jp, jnp.asarray(x), JCFG,
                                x_prev=None if prev is None
                                else jnp.asarray(prev), chunk=chunk)
    out = rwkv6.apply_rwkv6(p, torch.from_numpy(x), CFG,
                            x_prev=None if prev is None
                            else torch.from_numpy(prev), chunk=chunk)
    _close(out, ref, **SAME_TOL)


def test_apply_rwkv6_ref_matches_reference():
    jp, p = _layer(4)
    x = _x(5, n=24)
    ref = jax_rwkv6.apply_rwkv6_ref(jp, jnp.asarray(x), JCFG)
    out = rwkv6.apply_rwkv6_ref(p, torch.from_numpy(x), CFG)
    _close(out, ref, **SAME_TOL)


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_equals_sequential(chunk):
    """The reference's ``test_chunked_equals_sequential`` on the port."""
    _, p = _layer(0)
    x = torch.from_numpy(_x(0))
    _close(rwkv6.apply_rwkv6(p, x, CFG, chunk=chunk),
           rwkv6.apply_rwkv6_ref(p, x, CFG), **CHUNK_TOL)


def test_apply_rwkv6_refuses_a_ragged_length():
    _, p = _layer(0)
    with pytest.raises(ValueError, match="multiple of chunk"):
        rwkv6.apply_rwkv6(p, torch.from_numpy(_x(0, n=40)), CFG)


@pytest.mark.parametrize("start", ["fresh", "bumped"])
def test_decode_step_matches_reference(start):
    """Eight tokens through both packages' ``decode_step``: the outputs
    and every field of the cache. "bumped" starts from a random S, the
    reference's ``test_state_carries_context``: its first output must
    differ from the fresh start's."""
    jp, p = _layer(5)
    xs = _x(6, n=8)
    jcache = jax_rwkv6.init_cache(JCFG, B, dtype=jnp.float32)
    cache = rwkv6.init_cache(CFG, B, torch.float32)
    for a, b in zip(cache, jcache):
        assert tuple(a.shape) == b.shape
    assert cache.S.dtype == torch.float32
    if start == "bumped":
        bump = np.array(jax.random.normal(jax.random.PRNGKey(5),
                                          jcache.S.shape))
        jcache = jcache._replace(S=jcache.S + bump)
        cache = cache._replace(S=cache.S + torch.from_numpy(bump))
        y_fresh, _ = rwkv6.decode_step(
            p, torch.from_numpy(xs[:, :1]),
            rwkv6.init_cache(CFG, B, torch.float32), CFG)
    step = jax.jit(lambda p_, x, c: jax_rwkv6.decode_step(p_, x, c, JCFG))
    for t in range(xs.shape[1]):
        x = xs[:, t:t + 1]
        jy, jcache = step(jp, jnp.asarray(x), jcache)
        y, cache = rwkv6.decode_step(p, torch.from_numpy(x), cache, CFG)
        _close(y, jy, **SAME_TOL)
        for a, b in zip(cache, jcache):
            _close(a, b, **SAME_TOL)
        if t == 0 and start == "bumped":
            assert float((y - y_fresh).abs().max()) > 1e-6


def test_decode_steps_equal_the_chunked_forward():
    """Token by token through ``decode_step`` from a fresh cache equals
    the chunked form on the whole sequence (CHUNK_TOL)."""
    _, p = _layer(6)
    x = torch.from_numpy(_x(7, n=32))
    cache = rwkv6.init_cache(CFG, B, torch.float32)
    ys = []
    for t in range(x.shape[1]):
        y, cache = rwkv6.decode_step(p, x[:, t:t + 1], cache, CFG)
        ys.append(y)
    _close(torch.cat(ys, dim=1), rwkv6.apply_rwkv6(p, x, CFG), **CHUNK_TOL)


def test_channel_mix_matches_reference():
    jp = jax_mlp.init_mlp(JCFG, jax.random.PRNGKey(7))
    p = {k: _t(v) for k, v in jp.items()}
    x, prev = _x(8, n=12), _x(9, n=12)
    ref = jax_mlp.apply_mlp(jp, jnp.asarray(x), JCFG,
                            x_prev=jnp.asarray(prev))
    out = mlp.apply_mlp(p, torch.from_numpy(x), CFG,
                        x_prev=torch.from_numpy(prev))
    _close(out, ref, **SAME_TOL)
    with pytest.raises(ValueError, match="x_prev"):
        mlp.apply_mlp(p, torch.from_numpy(x), CFG)


# -- the decay clamp: overflow above the chunk's diagonal ---------------------

def _grads_port(fn, p, x, gy, **kw):
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xl = torch.from_numpy(x).requires_grad_(True)
    y = fn(live, xl, CFG, **kw)
    (y * torch.from_numpy(gy)).sum().backward()
    return y.detach(), {"x": xl.grad, **{k: live[k].grad for k in live}}


def test_chunked_gradient_is_finite_at_the_decay_clamp():
    """Every w0 at +2, so every per-token log decay sits at its clamp of
    -5 and a chunk of 32 sums to -160: above the diagonal the chunked
    form's factors multiply to e^160 and overflow. The port clears them
    with ``where``, so its forward equals the reference's and its
    gradients (x and every leaf) are finite and equal ``jax.grad`` of
    the reference and its own recurrence's, within GRAD_REL of each
    leaf's largest |b|. The rwkv6 counterpart of
    ``test_chunked_mamba2_gradient_is_finite_at_strong_decays``."""
    jp, p = _layer(8, w0=2.0)
    x = _x(10)
    gy = np.random.RandomState(11).randn(B, T, CFG.d_model).astype(
        np.float32)
    lw = p["w0"] + torch.tanh(torch.from_numpy(x) @ p["w_lora_a"]) @ \
        p["w_lora_b"]
    assert float(lw.min()) > 1.609              # every decay clamped

    def jloss(params, xj):
        return jnp.sum(jax_rwkv6.apply_rwkv6(params, xj, JCFG) * gy)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    ref_y = jax_rwkv6.apply_rwkv6(jp, jnp.asarray(x), JCFG)
    ref = {"x": np.asarray(jg_x), **{k: np.asarray(v)
                                      for k, v in jg_p.items()}}
    y, chunked = _grads_port(rwkv6.apply_rwkv6, p, x, gy)
    _, seq = _grads_port(rwkv6.apply_rwkv6_ref, p, x, gy)
    _close(y, ref_y, **SAME_TOL)
    for name, g in chunked.items():
        assert bool(torch.isfinite(g).all()), name
        for other in (ref[name], seq[name].numpy()):
            scale = float(np.abs(other).max())
            assert float(np.abs(g.numpy() - other).max()) <= \
                GRAD_REL * scale, name


# -- the whole model ------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(JCFG)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = model_params_from_jax(CFG, jax.tree.map(np.asarray, params),
                                  device="cpu")
    tokens = np.random.RandomState(1).randint(
        0, CFG.vocab_size, (B, 128)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    ref = {"hidden": jmodel.hidden(params, jbatch)[0],
           "apply": jmodel.apply(params, jbatch)[0],
           "embed_pool": jmodel.embed_pool(params, jbatch)}
    return params, model, {"tokens": torch.from_numpy(tokens)}, ref


@pytest.mark.parametrize("fn", ["hidden", "apply", "embed_pool"])
@pytest.mark.parametrize("plain", [False, True])
def test_model_matches_reference(pair, fn, plain):
    _, model, batch, ref = pair
    out = getattr(model, fn)(batch, plain=plain)
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == ref[fn].shape and out.dtype == torch.float32
    _close(out, ref[fn], **SAME_TOL)


def test_params_carried_and_counted(pair):
    params, model, _, _ = pair
    assert len(model.blocks) == CFG.n_layers
    for i, block in enumerate(model.blocks):
        for mod, leaf in (("tmix", "w_lora_a"), ("tmix", "u"),
                          ("cmix", "w_k"), ("norm2", "bias")):
            np.testing.assert_array_equal(
                block[mod][leaf].numpy(),
                np.asarray(params["blocks"][mod][leaf])[i])
    n = sum(p.numel() for p in Model(CFG, device="cpu", seed=3).parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(params))


def test_future_tokens_do_not_leak():
    """``tests/test_causality.py``'s test on the port's rwkv6."""
    model = Model(CFG, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    Bc, Tc, cut = 2, 24, 11
    toks = rng.randint(0, CFG.vocab_size, (Bc, Tc)).astype(np.int32)
    toks2 = toks.copy()
    toks2[:, cut:] = rng.randint(0, CFG.vocab_size, (Bc, Tc - cut))
    la, _ = model.apply({"tokens": torch.from_numpy(toks)})
    lb, _ = model.apply({"tokens": torch.from_numpy(toks2)})
    _close(la[:, :cut], lb[:, :cut], rtol=1e-4, atol=1e-4)
    assert float((la[:, cut:] - lb[:, cut:]).abs().max()) > 1e-4
