"""The port's vlm and audio families held against the JAX reference's.

``pixtral-12b-reduced`` (the vlm family: a Mistral-Nemo decoder, GQA 4 /
2 at Dh 64, RoPE at theta 1e9, swiglu, rmsnorm) and
``hubert-xlarge-reduced`` (the audio family: a non-causal encoder, MHA 4
heads, layernorm, gelu, ``attn_bias``, no decode step), 2 layers at
d_model 256, f32, B 2, T 32. Both take ``input_kind="embeddings"``: a
batch of frame / patch embeddings enters through ``frontend_proj``
(``common.embed_frontend``), a batch of tokens through the token
embedding (pixtral decodes on tokens).

One numpy seed feeds both packages. The reference's ``Model.init`` tree
comes across with ``convert.model_params_from_jax``, after every leaf
that the init leaves constant (the attention biases ``bq`` / ``bk`` /
``bv`` / ``bo``, the gelu MLP's ``b_up`` / ``b_down``, the layernorm
biases at 0, the norm scales at 1) is given seeded N(0, 0.1^2) noise in
the reference's tree, so no bias is held at zero.

Tolerances. The port runs the reference's forms in the same order of
casts; only the summation order of the products differs: rtol 1e-4,
atol 1e-5 (``SAME_TOL``, as ``test_torch_model.py``), for the forward,
decode step by step, decode against the port's own ``apply`` (naive
attention in both), and the loss. Gradients: max |a - b| within
``GRAD_REL`` = 1e-4 of the leaf's largest |b| (sums that cancel); a
leaf the batch does not reach (``tok`` under frame embeddings,
``frontend_proj`` under tokens) has a gradient of exactly zero on both
sides. The params after one AdamW step: AdamW's first step moves a
weight by about lr times the sign of its gradient, so where the
reference's gradient is within twice the gradient bound of zero its
sign is not determined, and the two packages may part there by up to
2 lr; elsewhere within rtol 1e-4 + atol 1e-6. ``rope_freqs`` at theta
1e9 and Dh 128 within 2 ulp (the two packages' f32 ``pow`` may round
apart). The embedding batches of ``launch/train.py`` are bit-equal
to the reference launcher's.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import RunConfig as JaxRunConfig
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common

from repro_torch import tree
from repro_torch.configs import RunConfig, get_config
from repro_torch.convert import model_params_from_jax, train_state_from_jax
from repro_torch.kernels._dispatch import topk_by_distance
from repro_torch.launch import serve_embeddings, steps, train
from repro_torch.models import Model, common
from repro_torch.models.transformer import unstack_blocks
from repro_torch.optim import schedules

NAMES = ["pixtral-12b", "hubert-xlarge"]
B, T = 2, 32
SAME_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
ROPE_ULP = 2
RUN = dict(lr=1e-3, warmup=2, total_steps=10, remat=False)
# (config, batch kind) of every whole-model case: hubert has no tokens
# path to serve (encoder-only, fed frames); pixtral takes both
CASES = [("pixtral-12b", "embeddings"), ("pixtral-12b", "tokens"),
         ("hubert-xlarge", "embeddings")]


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _cfgs(name):
    jcfg = jax_reduced(jax_get_config(name)).replace(dtype="float32")
    cfg = get_config(name + "-reduced").replace(dtype="float32")
    return jcfg, cfg


def _perturb(tree_np, rng):
    """``tree_np`` (nested dicts of numpy arrays) with seeded N(0, 0.1^2)
    noise added to every leaf the init leaves constant (biases at 0,
    norm scales at 1); the other leaves as they are."""
    if isinstance(tree_np, dict):
        return {k: _perturb(tree_np[k], rng) for k in sorted(tree_np)}
    a = np.asarray(tree_np)
    if a.size > 1 and np.all(a == a.reshape(-1)[0]):
        return (a + 0.1 * rng.randn(*a.shape)).astype(a.dtype)
    return a


def _ref_params(jcfg, seed=0):
    """The reference's ``Model.init`` tree (numpy) with its constant
    leaves perturbed."""
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    return _perturb(jax.tree.map(np.asarray, params),
                    np.random.RandomState(seed + 100))


def _batch(cfg, kind, seed=1, shape=(B, T)):
    """One numpy batch of ``kind``: frame / patch embeddings (f32) or
    token ids (int32)."""
    rng = np.random.RandomState(seed)
    if kind == "embeddings":
        return {kind: rng.randn(*shape, cfg.d_model).astype(np.float32)}
    return {kind: rng.randint(0, cfg.vocab_size, shape).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- building blocks ---------------------------------------------------------

@pytest.mark.parametrize("name", NAMES + ["smollm-135m"])
def test_init_embedding_keys_and_frontend_shape(name):
    jcfg, cfg = _cfgs(name)
    ref = jax_common.init_embedding(jcfg, jax.random.PRNGKey(0))
    mine = common.init_embedding(cfg, torch.Generator().manual_seed(0))
    assert sorted(mine) == sorted(ref)
    assert ("frontend_proj" in mine) == (cfg.input_kind == "embeddings")
    for k in mine:
        assert tuple(mine[k].shape) == ref[k].shape
        assert mine[k].dtype == torch.float32
    if "frontend_proj" in mine:
        # he_init with fan-in d_model: std 1 / sqrt(d)
        std = float(mine["frontend_proj"].std()) * np.sqrt(cfg.d_model)
        assert 0.9 < std < 1.1, std


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_frontend_matches_reference(name, dtype):
    jcfg, cfg = _cfgs(name)
    p = {"frontend_proj": np.random.RandomState(3).randn(
        cfg.d_model, cfg.d_model).astype(np.float32) / 16}
    e = _batch(cfg, "embeddings")["embeddings"]
    ref = jax_common.embed_frontend({"frontend_proj": jnp.asarray(
        p["frontend_proj"])}, jnp.asarray(e), jcfg, jnp.dtype(dtype))
    out = common.embed_frontend({"frontend_proj": torch.from_numpy(
        p["frontend_proj"])}, torch.from_numpy(e), cfg,
        getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    tol = SAME_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    _close(out.float(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dh", [64, 128])
def test_rope_at_theta_1e9_matches_reference(dh):
    """pixtral's RoPE base: the frequencies within ROPE_ULP ulp, and the
    rotation over 4,096 positions within SAME_TOL."""
    ref = np.asarray(jax_common.rope_freqs(dh, 1e9))
    out = common.rope_freqs(dh, 1e9).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    ulp = np.abs(out.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert ulp.max() <= ROPE_ULP, ulp.max()
    x = np.random.RandomState(4).randn(1, 4096, 2, dh).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)[None]
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e9),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e9),
           **SAME_TOL)


# -- whole models ------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(name, reference model, its perturbed params as jax arrays, the
    port model holding them)."""
    jcfg, cfg = _cfgs(request.param)
    params_np = _ref_params(jcfg)
    model = model_params_from_jax(cfg, params_np, device="cpu")
    return (request.param, jax_build_model(jcfg),
            jax.tree.map(jnp.asarray, params_np), model)


def test_params_and_count_equal_reference(pair):
    name, jmodel, params, model = pair
    cfg = model.cfg
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert sum(p.numel() for p in Model(cfg, device="cpu").parameters()) \
        == n_ref
    np.testing.assert_array_equal(
        model.embedding.frontend_proj.numpy(),
        np.asarray(params["embedding"]["frontend_proj"]))
    ported = model.param_tree()
    assert "frontend_proj" in ported["embedding"]
    if cfg.attn_bias:
        for i, block in enumerate(ported["blocks"]):
            for key in ("bq", "bk", "bv", "bo"):
                ref = np.asarray(params["blocks"]["attn"][key])[i]
                assert np.abs(ref).max() > 0
                np.testing.assert_array_equal(block["attn"][key].numpy(),
                                              ref)


@pytest.fixture(scope="module")
def forwards():
    """Both packages' hidden / apply / embed_pool on every case, with
    the port's kernel-path dispatch and ``plain=True``."""
    out = {}
    for name, kind in CASES:
        jcfg, cfg = _cfgs(name)
        params_np = _ref_params(jcfg)
        jmodel, params = jax_build_model(jcfg), jax.tree.map(jnp.asarray,
                                                             params_np)
        model = model_params_from_jax(cfg, params_np, device="cpu")
        batch = _batch(cfg, kind)
        ref = {"hidden": jmodel.hidden(params, _jax(batch))[0],
               "apply": jmodel.apply(params, _jax(batch))[0],
               "embed_pool": jmodel.embed_pool(params, _jax(batch))}
        mine = {}
        with torch.inference_mode():
            for plain in (False, True):
                mine[plain] = {
                    "hidden": model.hidden(_torch(batch), plain=plain)[0],
                    "apply": model.apply(_torch(batch), plain=plain)[0],
                    "embed_pool": model.embed_pool(_torch(batch),
                                                   plain=plain)}
        out[name, kind] = (ref, mine)
    return out


@pytest.mark.parametrize("name,kind", CASES)
@pytest.mark.parametrize("fn", ["hidden", "apply", "embed_pool"])
@pytest.mark.parametrize("plain", [False, True])
def test_model_matches_reference(forwards, name, kind, fn, plain):
    ref, mine = forwards[name, kind]
    out = mine[plain][fn]
    assert out.shape == ref[fn].shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    _close(out, ref[fn], **SAME_TOL)


def test_frames_and_tokens_take_different_embeddings(forwards):
    """pixtral's two entries differ: frames go through ``frontend_proj``,
    tokens through ``tok``."""
    a = forwards["pixtral-12b", "embeddings"][1][False]["hidden"]
    b = forwards["pixtral-12b", "tokens"][1][False]["hidden"]
    assert float((a - b).abs().max()) > 1e-2


def test_serve_embeddings_takes_frame_batches(pair):
    """``serve_embeddings.serve`` on frame / patch batch dicts embeds the
    corpus as the reference's ``embed_pool`` does and ranks each request
    in the (distance, id) order; requests equal to corpus rows 1 and 7
    find themselves first."""
    name, jmodel, params, model = pair
    cfg = model.cfg
    corpus = [_batch(cfg, "embeddings", seed=s, shape=(4, 16))
              for s in (2, 3)]
    rows = np.stack([corpus[0]["embeddings"][1], corpus[1]["embeddings"][3]])
    L = torch.from_numpy(np.random.RandomState(4).randn(
        16, cfg.d_model).astype(np.float32))
    out = serve_embeddings.serve(model, L, [_torch(b) for b in corpus],
                                 [{"embeddings": torch.from_numpy(rows)}],
                                 k=4)
    ref = np.concatenate([np.asarray(jmodel.embed_pool(params, _jax(b)))
                          for b in corpus])
    _close(out["corpus_emb"], ref, **SAME_TOL)
    assert out["ids"][:, 0].tolist() == [1, 7]
    emb = out["corpus_emb"]
    D = ((out["request_emb"][:, None] - emb[None]) @ L.T).square().sum(-1)
    d, i = topk_by_distance(D, torch.arange(8, dtype=torch.int32)
                            .expand(2, -1), 4)
    assert torch.equal(i, out["ids"])
    # pairwise_sqdist's |x|^2 + |y|^2 - 2 x.y form rounds a zero distance
    # to within a few f32 ulp of the largest distance
    _close(out["dists"], d, rtol=1e-4, atol=1e-6 * float(D.max()))
    assert out["requests_per_s"] * out["wall_s"] == pytest.approx(2)
    assert out["tokens_per_s"] * out["wall_s"] == pytest.approx(32)
    with pytest.raises(ValueError, match="k=9"):
        serve_embeddings.serve(model, L, [_torch(b) for b in corpus],
                               [{"embeddings": torch.from_numpy(rows)}], k=9)


def test_encoder_is_bidirectional(pair):
    """The port's counterpart of ``tests/test_causality.py``'s
    ``test_encoder_is_bidirectional`` (hubert: moving the late frames
    moves the early positions), and pixtral's causality (moving the late
    patches leaves the early positions as they were), on both packages."""
    name, jmodel, params, model = pair
    cfg = model.cfg
    rng = np.random.RandomState(2)
    cut = T // 2
    e1 = rng.randn(B, T, cfg.d_model).astype(np.float32)
    e2 = e1.copy()
    e2[:, cut:] += rng.randn(B, T - cut, cfg.d_model).astype(np.float32)
    with torch.inference_mode():
        la = model.apply({"embeddings": torch.from_numpy(e1)})[0]
        lb = model.apply({"embeddings": torch.from_numpy(e2)})[0]
    ja = jmodel.apply(params, {"embeddings": jnp.asarray(e1)})[0]
    jb = jmodel.apply(params, {"embeddings": jnp.asarray(e2)})[0]
    early = float((la[:, :cut] - lb[:, :cut]).abs().max())
    jearly = float(jnp.max(jnp.abs(ja[:, :cut] - jb[:, :cut])))
    assert float((la[:, cut:] - lb[:, cut:]).abs().max()) > 1e-4
    if cfg.causal:
        assert name == "pixtral-12b"
        _close(la[:, :cut], lb[:, :cut], rtol=1e-4, atol=1e-4)
        assert jearly < 1e-4
    else:
        assert name == "hubert-xlarge"
        assert early > 1e-4 and jearly > 1e-4
        _close(early, jearly, rtol=1e-3)


# -- decode -------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoded():
    """pixtral's decode in both packages on the same teacher-forced
    tokens, from an empty cache."""
    jcfg, cfg = _cfgs("pixtral-12b")
    params_np = _ref_params(jcfg)
    jmodel, params = jax_build_model(jcfg), jax.tree.map(jnp.asarray,
                                                         params_np)
    model = model_params_from_jax(cfg, params_np, device="cpu")
    toks = _batch(cfg, "tokens", seed=5, shape=(B, 20))["tokens"]
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_decode_cache(B, 20)
    cache = model.init_decode_cache(B, 20)
    jlog, log = [], []
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            lg, jcache = jstep(params, jcache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
            jlog.append(np.asarray(lg))
            lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, t]),
                                          t)
            log.append(lg.numpy())
    return model, toks, np.stack(jlog, 1), np.stack(log, 1)


def test_pixtral_decode_matches_reference(decoded):
    model, toks, ref, out = decoded
    assert out.shape == (B, toks.shape[1], model.cfg.vocab_size)
    assert np.isfinite(out).all()
    _close(out, ref, **SAME_TOL)


def test_pixtral_decode_matches_own_forward(decoded):
    model, toks, _, out = decoded
    with torch.inference_mode():
        full, _ = model.apply({"tokens": torch.from_numpy(toks)})
        plain, _ = model.apply({"tokens": torch.from_numpy(toks)},
                               plain=True)
    _close(out, full, **SAME_TOL)
    _close(out, plain, **SAME_TOL)


def test_hubert_has_no_decode_step():
    jcfg, cfg = _cfgs("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        jax_build_model(jcfg).init_decode_cache(2, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        Model(cfg, device="cpu").init_decode_cache(2, 16)


# -- one train step -----------------------------------------------------------

def _ref_loss(jmodel, params, batch):
    h, aux = jmodel.hidden(params, batch)
    ce = jax_steps.chunked_ce_loss(jmodel, params, h, batch["labels"], 2)
    return ce + jmodel.cfg.moe_aux_weight * aux["moe_aux"], ce


def _port_loss(model, params, batch):
    h, aux = model.hidden(batch, plain=True, params=params)
    ce = steps.chunked_ce_loss(model, params, h, batch["labels"], 2)
    return ce + model.cfg.moe_aux_weight * aux["moe_aux"], ce


@pytest.mark.parametrize("name,kind", CASES)
def test_one_train_step_matches_reference(name, kind):
    """The loss and every gradient leaf against ``jax.value_and_grad``
    of the reference's loss (the unreached leaf exactly zero on both
    sides), then one step of each package's ``make_train_step`` (global
    norm clip, AdamW) from one state: loss, grad norm and params."""
    jcfg, cfg = _cfgs(name)
    params_np = _ref_params(jcfg)
    jmodel = jax_build_model(jcfg)
    batch = _batch(cfg, kind, seed=6)
    batch["labels"] = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params_np)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: _ref_loss(jmodel, p, _jax(batch)), has_aux=True)(jparams)
    model = model_params_from_jax(cfg, params_np, device="cpu")
    (loss, _), grads = tree.value_and_grad(
        lambda p, b: _port_loss(model, p, b), model.param_tree(),
        _torch(batch))
    _close(loss, jloss, **SAME_TOL)
    ref_grads = unstack_blocks(jax.tree.map(np.asarray, jgrads))
    unused = "tok" if kind == "embeddings" else "frontend_proj"
    assert not np.any(ref_grads["embedding"][unused])
    assert not torch.any(grads["embedding"][unused])
    reached = []

    def check(a, b):
        a = a.numpy()
        assert a.shape == b.shape and np.isfinite(a).all()
        top = np.abs(b).max()
        reached.append(top > 0)
        assert np.abs(a - b).max() <= GRAD_REL * top
    tree.tree_map(check, grads, ref_grads)
    assert sum(reached) == len(reached) - 1   # only the unreached leaf

    run = dict(RUN)
    jrun, prun = JaxRunConfig(**run), RunConfig(**run)
    jopt = jax_steps.make_optimizer(jrun)
    jstate = jax_steps.TrainState(jparams, jopt.init(jparams),
                                  jnp.zeros((), jnp.int32))
    model, state = train_state_from_jax(
        cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstate, jm = jax.jit(jax_steps.make_train_step(
        jmodel, jopt, jrun, loss_chunks=2))(jstate, _jax(batch))
    state, m = steps.make_train_step(model, steps.make_optimizer(prun), prun,
                                     loss_chunks=2)(state, _torch(batch))
    for key in ("loss", "grad_norm", "ce"):
        _close(m[key], jm[key], rtol=1e-4)
    ref = unstack_blocks(jax.tree.map(np.asarray, jstate.params))
    start = unstack_blocks(params_np)
    lr_t = float(schedules.cosine(RUN["lr"], RUN["total_steps"],
                                  warmup=RUN["warmup"])(torch.tensor(1)))

    def check_step(a, b, g, p0):
        a = a.numpy()
        free = np.abs(g) <= 2 * GRAD_REL * np.abs(g).max()
        np.testing.assert_allclose(a[~free], b[~free], **STEP_TOL)
        assert np.abs(a - b)[free].max(initial=0.0) <= 2 * lr_t + 1e-6
        if not np.any(g):            # the unreached leaf: decay alone
            np.testing.assert_allclose(a, b, **STEP_TOL)
            assert not np.array_equal(a, p0)
    tree.tree_map(check_step, state.params, ref, ref_grads, start)


# -- the launcher's batches ---------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_embedding_batches_bit_equal_reference_launcher(name, monkeypatch):
    """``launch/train.py``'s frame / patch batches against the
    reference launcher's own (``repro.launch.train.main`` run with its
    train step replaced by a recorder): bit-equal, three steps."""
    seen = []

    def recorder(model, opt, run, mesh=None, loss_chunks=8):
        def step(state, batch):
            seen.append(jax.tree.map(np.asarray, batch))
            return state, {"loss": 0.0, "grad_norm": 0.0}
        return step

    monkeypatch.setattr(jax_train.steps_lib, "make_train_step", recorder)
    monkeypatch.setattr(jax_train, "jax", SimpleNamespace(
        jit=lambda f: f, random=jax.random, tree=jax.tree))
    monkeypatch.setattr(sys, "argv", ["train", "--arch", name, "--reduced",
                                      "--steps", "3", "--batch", "2",
                                      "--seq", "16"])
    jax_train.main()
    cfg = get_config(name + "-reduced")
    assert cfg.input_kind == "embeddings" and len(seen) == 3
    stream = train.embedding_batches(cfg, 2, 16, device="cpu")
    for ref in seen:
        mine = next(stream)
        assert sorted(mine) == sorted(ref) == ["embeddings", "labels"]
        assert mine["embeddings"].dtype == torch.float32
        assert mine["labels"].dtype == torch.int32
        for k in ref:
            np.testing.assert_array_equal(mine[k].numpy(), ref[k])
