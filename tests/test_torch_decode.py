"""The port's decode path held against the JAX reference's.

One numpy seed feeds both packages; the reference's parameters
(``Model.init`` from a PRNG key) come across with
``convert.model_params_from_jax`` and its caches with
``convert.decode_cache_from_jax``. Everything runs in f32 at reduced
width (2 layers, d_model <= 256; zamba2: one group of 2 mamba2 layers
and the shared block; rwkv6: 4 heads of 64).

Tolerances. Step against step (``mamba2.decode_step``,
``attention.decode_attend``, ``Model.decode_step``) the two packages run
the same operations in the same order of casts, and only the summation
order of the products differs: rtol 1e-4, atol 1e-5 (the port's
``SAME_TOL`` in ``test_torch_model.py``). The port's decode against its
own ``apply(plain=True)``: the dense family runs the same naive
attention (rtol 1e-4, atol 1e-5); the hybrid family's full forward is
the chunked SSD against decode's exact recurrence (rtol 2e-3, atol 2e-4,
the reference's bound between those forms); the ssm family's is the
chunked wkv against decode's exact recurrence (rtol 1e-3, atol 1e-4,
the reference's bound between those forms for rwkv6). The greedy loop's tokens
must be equal wherever the reference's top-2 logit gap exceeds 1e-3,
far above the logits' f32 differences, which the step-by-step tests
bound by atol 1e-5 + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jax_mamba2
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, get_shape
from repro_torch.convert import decode_cache_from_jax, model_params_from_jax
from repro_torch.launch import serve, steps
from repro_torch.models import attention, mamba2
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.rwkv6 import RWKVCache

F32 = dict(dtype="float32", ssm_tile_dtype="float32")
SAME_TOL = dict(rtol=1e-4, atol=1e-5)
SSD_TOL = dict(rtol=2e-3, atol=2e-4)
RWKV_TOL = dict(rtol=1e-3, atol=1e-4)
GAP = 1e-3
B, T = 2, 20


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _pair(name, **over):
    """(reference cfg, port cfg, reference model, reference params, port
    model) at reduced width in f32."""
    jcfg = jax_reduced(jax_get_config(name)).replace(**F32, **over)
    cfg = get_config(name + "-reduced").replace(**F32, **over)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = model_params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    return jcfg, cfg, jmodel, params, model


def _tokens(cfg, seed=1, n=T):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


# -- the layers -----------------------------------------------------------------

def test_mamba2_decode_step_matches_reference():
    jcfg = jax_reduced(jax_get_config("zamba2-2.7b")).replace(**F32)
    cfg = get_config("zamba2-2.7b-reduced").replace(**F32)
    jp = jax_mamba2.init_mamba2(jcfg, jax.random.PRNGKey(3))
    p = {k: _t(v) for k, v in jp.items()}
    xs = np.random.RandomState(0).randn(12, B, 1, cfg.d_model).astype(
        np.float32)
    jcache = jax_mamba2.init_cache(jcfg, B, dtype=jnp.float32)
    cache = mamba2.init_cache(cfg, B, torch.float32)
    assert tuple(cache.h.shape) == jcache.h.shape
    assert tuple(cache.conv.shape) == jcache.conv.shape
    step = jax.jit(lambda p_, x, c: jax_mamba2.decode_step(p_, x, c, jcfg))
    for x in xs:
        jy, jcache = step(jp, jnp.asarray(x), jcache)
        y, cache = mamba2.decode_step(p, torch.from_numpy(x), cache, cfg)
        assert cache.h.dtype == torch.float32
        _close(y, jy, **SAME_TOL)
        _close(cache.h, jcache.h, **SAME_TOL)
        _close(cache.conv, jcache.conv, **SAME_TOL)


def test_causal_conv_history_matches_reference():
    jcfg = jax_reduced(jax_get_config("zamba2-2.7b")).replace(**F32)
    jp = jax_mamba2.init_mamba2(jcfg, jax.random.PRNGKey(4))
    rng = np.random.RandomState(2)
    C = jp["conv_w"].shape[1]
    x = rng.randn(B, 5, C).astype(np.float32)
    hist = rng.randn(B, jcfg.conv_width - 1, C).astype(np.float32)
    for h in (None, hist):
        ref = jax_mamba2._causal_conv(jnp.asarray(x), jp["conv_w"],
                                      jp["conv_b"],
                                      None if h is None else jnp.asarray(h))
        out = mamba2._causal_conv(torch.from_numpy(x), _t(jp["conv_w"]),
                                  _t(jp["conv_b"]),
                                  None if h is None else torch.from_numpy(h))
        _close(out, ref, **SAME_TOL)


@pytest.mark.parametrize("window", [None, 8], ids=["full", "sliding8"])
def test_decode_attend_matches_reference(window):
    over = {} if window is None else dict(attention="sliding", window=window)
    jcfg = jax_reduced(jax_get_config("yi-6b")).replace(**F32, **over)
    cfg = get_config("yi-6b-reduced").replace(**F32, **over)
    jp = jax_attention.init_attention(jcfg, jax.random.PRNGKey(5))
    p = {k: _t(v) for k, v in jp.items()}
    xs = np.random.RandomState(3).randn(T, B, 1, cfg.d_model).astype(
        np.float32)
    jcache = jax_attention.init_cache(jcfg, B, T, dtype=jnp.float32)
    cache = attention.init_cache(cfg, B, T, torch.float32)
    S = T if window is None else window
    assert tuple(cache.k.shape) == jcache.k.shape == (B, S, cfg.kv_heads,
                                                      cfg.dim_per_head)
    step = jax.jit(lambda p_, x, c, pos: jax_attention.decode_attend(
        p_, x, c, pos, jcfg))
    for pos, x in enumerate(xs):          # 20 steps: the ring of 8 wraps
        jy, jcache = step(jp, jnp.asarray(x), jcache, jnp.int32(pos))
        y, cache = attention.decode_attend(p, torch.from_numpy(x), cache,
                                           pos, cfg)
        _close(y, jy, **SAME_TOL)
        _close(cache.k, jcache.k, **SAME_TOL)
        _close(cache.v, jcache.v, **SAME_TOL)


# -- whole models ---------------------------------------------------------------

# dense (smollm GQA 4 / 2, gemma at its head dim of 256, yi), yi with a
# ring that wraps, hybrid zamba2 with its shared block's window at 64 and
# at 8 (the ring of 8 wraps in 20 steps), and the ssm family (rwkv6)
MODELS = {
    "smollm-135m": ("smollm-135m", {}),
    "gemma-7b": ("gemma-7b", dict(head_dim=256)),
    "yi-6b": ("yi-6b", {}),
    "yi-6b-ring": ("yi-6b", dict(attention="sliding", window=8)),
    "zamba2-2.7b": ("zamba2-2.7b", {}),
    "zamba2-2.7b-ring": ("zamba2-2.7b", dict(shared_attn_window=8)),
    "rwkv6-1.6b": ("rwkv6-1.6b", {}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
}


@pytest.fixture(scope="module", params=list(MODELS))
def decoded(request):
    """Both packages decode the same teacher-forced tokens: the logits
    at every step, the port model and the reference's pieces."""
    name, over = MODELS[request.param]
    jcfg, cfg, jmodel, params, model = _pair(name, **over)
    toks = _tokens(cfg)
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_decode_cache(B, T)
    cache = model.init_decode_cache(B, T)
    jlog, log = [], []
    with torch.inference_mode():
        for t in range(T):
            lg, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
            jlog.append(np.asarray(lg))
            lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]),
                                          t)
            log.append(lg.numpy())
    return {"name": request.param, "cfg": cfg, "jcfg": jcfg,
            "jmodel": jmodel, "params": params, "model": model,
            "tokens": toks, "ref": np.stack(jlog, 1), "out": np.stack(log, 1)}


def test_model_decode_matches_reference(decoded):
    cfg = decoded["cfg"]
    assert decoded["out"].shape == (B, T, cfg.vocab_size)
    assert np.isfinite(decoded["out"]).all()
    _close(decoded["out"], decoded["ref"], **SAME_TOL)


def test_decode_matches_own_plain_forward(decoded):
    """As the reference's ``test_decode_matches_full_forward``: every
    teacher-forced step's logits equal ``apply`` at that position."""
    model, cfg = decoded["model"], decoded["cfg"]
    with torch.inference_mode():
        full, _ = model.apply({"tokens": torch.from_numpy(decoded["tokens"])},
                              plain=True)
    tol = {"hybrid": SSD_TOL, "ssm": RWKV_TOL}.get(cfg.family, SAME_TOL)
    _close(decoded["out"], full, **tol)


def test_mid_sequence_start_from_reference_cache(decoded):
    """The reference decodes 10 steps; its cache comes across and both
    packages decode the rest of the sequence from it."""
    jmodel, params, model = (decoded["jmodel"], decoded["params"],
                             decoded["model"])
    cfg, toks = decoded["cfg"], decoded["tokens"]
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_decode_cache(B, T)
    for t in range(10):
        _, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]),
                          jnp.int32(t))
    cache = decode_cache_from_jax(cfg, jax.tree.map(np.asarray, jcache),
                                  device="cpu")
    with torch.inference_mode():
        for t in range(10, T):
            jl, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
            lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]),
                                          t)
            _close(lg, jl, **SAME_TOL)
    for mine, ref in zip(cache["blocks"], _unstacked(jcache["blocks"])):
        for a, b in zip(mine, ref):
            _close(a, b, **SAME_TOL)


def _unstacked(stacked):
    return [type(stacked)(*(np.asarray(a)[i] for a in stacked))
            for i in range(len(stacked[0]))]


def test_cache_shapes_match_reference(decoded):
    jmodel, model, cfg = decoded["jmodel"], decoded["model"], decoded["cfg"]
    jcache = jmodel.init_decode_cache(B, 100)
    cache = model.init_decode_cache(B, 100)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        ref = jcache[key]
        assert type(cache[key][0]).__name__ == type(ref).__name__
        assert len(cache[key]) == ref[0].shape[0]
        for c in cache[key]:
            for a, r in zip(c, ref):
                assert tuple(a.shape) == r.shape[1:]
                assert a.dtype == torch.float32 and a.device.type == "cpu"
    if cfg.family == "hybrid":
        assert isinstance(cache["blocks"][0], MambaCache)
        assert cache["shared"][0].k.shape[1] == min(cfg.shared_attn_window,
                                                    100)
    elif cfg.family == "ssm":        # a fixed-size state: no max_seq
        assert isinstance(cache["blocks"][0], RWKVCache)
        assert cache["blocks"][0].S.shape == (B, cfg.n_heads,
                                              cfg.dim_per_head,
                                              cfg.dim_per_head)
    else:
        assert isinstance(cache["blocks"][0], KVCache)
        ring = cfg.attention == "sliding"
        assert cache["blocks"][0].k.shape[1] == (cfg.window if ring else 100)
    shape = get_shape("decode_32k")
    meta = steps.cache_shape_structs(model, shape)
    for c, m in zip(model.init_decode_cache(2, 16)["blocks"],
                    meta["blocks"]):
        assert all(a.device.type == "meta" for a in m)
        assert m[0].shape[0] == shape.global_batch


def test_ring_buffer_cache_sliding():
    """The reference's ``test_ring_buffer_cache_sliding`` on the port."""
    cfg = get_config("yi-6b-reduced").replace(attention="sliding", window=8)
    c = attention.init_cache(cfg, batch=2, max_seq=100, dtype=torch.float32)
    assert c.k.shape[1] == 8  # ring buffer, not max_seq
    assert attention.cache_len(cfg, 5) == 5
    assert attention.init_cache(cfg, 2, 100).k.dtype == torch.bfloat16


def test_encoder_only_has_no_decode():
    jcfg = jax_reduced(jax_get_config("yi-6b")).replace(causal=False)
    cfg = get_config("yi-6b-reduced").replace(causal=False)
    with pytest.raises(ValueError, match="encoder-only"):
        JaxModel(jcfg).init_decode_cache(2, 16)
    from repro_torch.models import Model
    with pytest.raises(ValueError, match="encoder-only"):
        Model(cfg, device="cpu").init_decode_cache(2, 16)


@pytest.mark.parametrize("name", ["smollm-135m", "zamba2-2.7b",
                                  "rwkv6-1.6b", "granite-moe-1b-a400m"])
def test_greedy_loop_matches_reference(name):
    """A 20-step greedy loop (4 prompt tokens, 16 generated) through
    ``launch.serve.generate`` and the reference's loop on the same
    weights: equal tokens wherever the reference's top-2 logit gap
    exceeds GAP; the first near-tie (if any) ends the comparison."""
    jcfg, cfg, jmodel, params, model = _pair(name)
    prompts = _tokens(cfg, seed=4, n=4)
    out = serve.generate(model, torch.from_numpy(prompts), 16)
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_decode_cache(B, 20)
    for t in range(4):
        lg, jcache = jstep(params, jcache, jnp.asarray(prompts[:, t]),
                           jnp.int32(t))
    toks, compared = np.asarray(jnp.argmax(lg, -1)), 0
    gen = out["tokens"].numpy()
    assert gen.shape == (B, 16)
    for t in range(16):
        top2 = np.sort(np.asarray(lg), -1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] <= GAP).any():
            break
        np.testing.assert_array_equal(gen[:, t], toks)
        compared += 1
        if t < 15:
            lg, jcache = jstep(params, jcache, jnp.asarray(toks),
                               jnp.int32(4 + t))
            toks = np.asarray(jnp.argmax(lg, -1))
    assert compared >= 8, f"only {compared} steps apart from ties"

