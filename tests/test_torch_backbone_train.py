"""The port's backbone training held against the JAX reference's.

``data.tokens`` (bit-equal batches), the shape records and launcher
configs, ``launch.steps`` (three AdamW steps from one state:
``convert.train_state_from_jax`` carries the reference's params and
optimizer state across), the reference's own training tests run on the
port (the loss falls, a resume is bit-exact), checkpoints read across
packages in both directions, and ``launch.serve`` / ``launch.train`` /
``launch.serve_embeddings`` on the CPU in subprocesses (rwkv6, the moe,
vlm and audio configs among the archs). Reduced widths, f32.

Tolerances for the three steps: both packages run the same forms
(chunked SSD, naive attention, chunked CE) in f32 and differ in the
summation order of products and of the global norm: loss and grad
norm within rtol 1e-4. AdamW's normalised update m / sqrt(v) carries a
gradient's relative difference into the params at the scale of lr, and
for a gradient near zero that relative difference is large (a sign flip
moves a weight by up to 2 lr a step). So the params after step 3: every
weight within rtol 1e-4 + atol 1e-4 (a tenth of one step's lr of 1e-3),
and at most one weight in 10^4 beyond rtol 1e-4 + atol 1e-6.
The first moment m, a sum of gradients, within 1e-4 of its leaf's
largest |m|: the gradients' f32 differences scale with the leaf, not
with each (possibly cancelling) entry.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import InputShape as JaxInputShape
from repro.configs.base import RunConfig as JaxRunConfig
from repro.data import tokens as jax_tokens
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model

from repro_torch.checkpoint import (_msgpack, latest_step, latest_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import (SHAPES, InputShape, RunConfig, get_config,
                                 get_shape)
from repro_torch.convert import train_state_from_jax
from repro_torch.data import tokens
from repro_torch.launch import steps
from repro_torch.models import Model
from repro_torch.models.transformer import stack_blocks, unstack_blocks
from repro_torch.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[1]
F32 = dict(dtype="float32", ssm_tile_dtype="float32")
STEP_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT_TOL = dict(rtol=1e-4, atol=1e-6)
TIGHT_SHARE = 1e-4
MOMENT_REL = 1e-4


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


# -- data and configs -----------------------------------------------------------

@pytest.mark.parametrize("V,Bt,Tt,seed", [(512, 4, 32, 0), (49152, 2, 64, 3)])
def test_token_stream_is_bit_equal(V, Bt, Tt, seed):
    ref = jax_tokens.token_stream(V, Bt, Tt, seed=seed)
    out = tokens.token_stream(V, Bt, Tt, seed=seed, device="cpu")
    for _ in range(3):
        r, o = next(ref), next(out)
        for key in ("tokens", "labels"):
            assert o[key].dtype == torch.int32 and o[key].device.type == "cpu"
            np.testing.assert_array_equal(o[key].numpy(), np.asarray(r[key]))


def test_embedding_stream_is_bit_equal():
    ref = jax_tokens.embedding_stream(24, 3, 5, n_classes=4, seed=2)
    out = tokens.embedding_stream(24, 3, 5, n_classes=4, seed=2,
                                  device="cpu")
    for _ in range(3):
        r, o = next(ref), next(out)
        np.testing.assert_array_equal(o["embeddings"].numpy(),
                                      np.asarray(r["embeddings"]))
        np.testing.assert_array_equal(o["labels"].numpy(),
                                      np.asarray(r["labels"]))


def test_shapes_and_run_config_equal_reference():
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name, ref in JAX_SHAPES.items():
        assert dataclasses.asdict(get_shape(name)) == dataclasses.asdict(ref)
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(
        JaxRunConfig())
    assert [f.name for f in dataclasses.fields(InputShape)] == \
        [f.name for f in dataclasses.fields(JaxInputShape)]
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_1k")


ARCHS = ["smollm-135m", "gemma-7b", "yi-6b", "zamba2-2.7b", "hubert-xlarge",
         "rwkv6-1.6b", "pixtral-12b", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
def test_effective_config_skip_reason_input_specs(arch, shape):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jshape, pshape = JAX_SHAPES[shape], get_shape(shape)
    assert dataclasses.asdict(steps.effective_config(cfg, pshape)) == \
        dataclasses.asdict(jax_steps.effective_config(jcfg, jshape))
    assert steps.skip_reason(cfg, pshape) == \
        jax_steps.skip_reason(jcfg, jshape)
    ref = jax_steps.input_specs(jcfg, jshape)
    out = steps.input_specs(cfg, pshape)
    assert sorted(out) == sorted(ref)
    for key, spec in ref.items():
        assert tuple(out[key].shape) == spec.shape
        assert out[key].device.type == "meta"
        assert str(out[key].dtype)[6:] == np.dtype(spec.dtype).name


# -- three train steps from one state ------------------------------------------

RUN = dict(lr=1e-3, warmup=2, total_steps=10, remat=False)


def _ref_setup(name, **over):
    jcfg = jax_reduced(jax_get_config(name)).replace(**F32, **over)
    cfg = get_config(name + "-reduced").replace(**F32, **over)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    return jcfg, cfg, jmodel, params


def _three_steps(name, remat):
    """Three AdamW steps of both packages from one state on one stream:
    (reference state, port state, port model, reference params); loss,
    grad norm and CE held at every step."""
    jcfg, cfg, jmodel, params = _ref_setup(name)
    run = dict(RUN, remat=remat)
    jrun, prun = JaxRunConfig(**run), RunConfig(**run)
    jopt = jax_steps.make_optimizer(jrun)
    jstate = jax_steps.TrainState(params, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    model, state = train_state_from_jax(cfg, jax.tree.map(np.asarray,
                                                          jstate),
                                        device="cpu")
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jopt, jrun,
                                              loss_chunks=2))
    step = steps.make_train_step(model, steps.make_optimizer(prun), prun,
                                 loss_chunks=2)
    jstream = jax_tokens.token_stream(cfg.vocab_size, 2, 32, seed=5)
    stream = tokens.token_stream(cfg.vocab_size, 2, 32, seed=5, device="cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, next(jstream))
        state, m = step(state, next(stream))
        for key in ("loss", "grad_norm", "ce"):
            _close(m[key], jm[key], **STEP_TOL)
    assert int(state.step) == 3 == int(jstate.step)
    return jstate, state, model, params


def _check_tight_share_and_moments(jstate, state):
    ref = unstack_blocks(jax.tree.map(np.asarray, jstate.params))
    beyond, total = [], []

    def count(a, b):
        beyond.append(int(np.sum(np.abs(a - b) > TIGHT_TOL["atol"]
                                 + TIGHT_TOL["rtol"] * np.abs(b))))
        total.append(b.size)
    tree_map(count, _np(state.params), ref)
    assert sum(beyond) <= TIGHT_SHARE * sum(total), (sum(beyond), sum(total))
    ref_m = unstack_blocks(jax.tree.map(np.asarray, jstate.opt_state.m))
    tree_map(lambda a, b: _close(a, b, rtol=0, atol=MOMENT_REL * np.abs(
        b).max()), _np(state.opt_state.m), ref_m)


@pytest.mark.parametrize("name,remat", [("smollm-135m", False),
                                        ("zamba2-2.7b", False),
                                        ("zamba2-2.7b", True),
                                        ("gemma-7b", False),
                                        ("granite-moe-1b-a400m", False),
                                        ("granite-moe-1b-a400m", True)])
def test_three_train_steps_match_reference(name, remat):
    jstate, state, model, params = _three_steps(name, remat)
    ref = unstack_blocks(jax.tree.map(np.asarray, jstate.params))
    tree_map(lambda a, b: _close(a, b, **PARAM_TOL), _np(state.params), ref)
    _check_tight_share_and_moments(jstate, state)
    # the step returns new tensors: the model's own weights stayed put
    assert torch.equal(model.embedding.tok, torch.from_numpy(
        np.array(params["embedding"]["tok"])))


@pytest.mark.parametrize("remat", [False, True])
def test_three_rwkv6_train_steps_match_reference(remat):
    """Three AdamW steps of rwkv6, each step taken by both packages from
    the reference's state before it (``train_state_from_jax``), with the
    other test's bounds on the loss, grad norm, CE, first moment and the
    tight share. Step 2's gradient has one embedding entry (token 97,
    channel 112) under 4e-6 of its row's largest on both sides, below
    the two packages' f32 gradient difference (about 1e-5 of a leaf's
    largest), so its sign is not determined and AdamW turns either sign
    into a full step; carried on, that one weight moves the next step's
    gradients past the moment bound. So each step starts from the
    reference's state, and the
    every-weight bound (PARAM_TOL) holds where the reference's first
    moment is above the moment check's own bound (MOMENT_REL of the
    leaf's largest |m|); there a weight may move by up to 2 lr (the
    sign flip), in at most two weights a step."""
    jcfg, cfg, jmodel, params = _ref_setup("rwkv6-1.6b")
    run = dict(RUN, remat=remat)
    jrun, prun = JaxRunConfig(**run), RunConfig(**run)
    jopt = jax_steps.make_optimizer(jrun)
    jstate = jax_steps.TrainState(params, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jopt, jrun,
                                              loss_chunks=2))
    stream = tokens.token_stream(cfg.vocab_size, 2, 32, seed=5, device="cpu")
    for _ in range(3):
        model, state = train_state_from_jax(
            cfg, jax.tree.map(np.asarray, jstate), device="cpu")
        step = steps.make_train_step(model, steps.make_optimizer(prun), prun,
                                     loss_chunks=2)
        batch = next(stream)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy())
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        for key in ("loss", "grad_norm", "ce"):
            _close(m[key], jm[key], **STEP_TOL)
        ref = unstack_blocks(jax.tree.map(np.asarray, jstate.params))
        ref_m = unstack_blocks(jax.tree.map(np.asarray, jstate.opt_state.m))
        flips = []

        def check(a, b, m_b):
            free = np.abs(m_b) <= MOMENT_REL * np.abs(m_b).max()
            _close(a[~free], b[~free], **PARAM_TOL)
            assert np.abs(a - b)[free].max(initial=0.0) <= 2 * RUN["lr"]
            flips.append(int(np.sum(free & (np.abs(a - b) > PARAM_TOL[
                "atol"] + PARAM_TOL["rtol"] * np.abs(b)))))
        tree_map(check, _np(state.params), ref, ref_m)
        assert sum(flips) <= 2, flips
        _check_tight_share_and_moments(jstate, state)
    assert int(state.step) == 3 == int(jstate.step)


def test_remat_gives_the_same_step():
    _, cfg, _, params = _ref_setup("zamba2-2.7b")
    outs = []
    for remat in (False, True):
        model = Model(cfg, device="cpu", seed=2)
        run = RunConfig(**dict(RUN, remat=remat))
        opt = steps.make_optimizer(run)
        step = steps.make_train_step(model, opt, run, loss_chunks=2)
        state = steps.init_train_state(model, opt)
        batch = next(tokens.token_stream(cfg.vocab_size, 2, 32, device="cpu"))
        outs.append(step(state, batch))
    (s0, m0), (s1, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_chunked_ce_loss_matches_full_logits():
    _, cfg, _, _ = _ref_setup("smollm-135m")
    model = Model(cfg, device="cpu")
    batch = next(tokens.token_stream(cfg.vocab_size, 2, 30, device="cpu"))
    from repro_torch.core.losses import softmax_cross_entropy
    with torch.no_grad():
        h, _ = model.hidden(batch, plain=True)
        logits, _ = model.apply(batch, plain=True)
        for n in (1, 4, 8):      # 4 and 8 fall back to 3 and 6 chunks of 30
            got = steps.chunked_ce_loss(model, model.param_tree(), h,
                                        batch["labels"], n)
            torch.testing.assert_close(
                got, softmax_cross_entropy(logits, batch["labels"]),
                rtol=1e-5, atol=1e-6)


def test_prefill_and_serve_steps():
    """``make_prefill_step`` is ``apply``'s logits; ``make_serve_step``
    decodes one position (rtol 1e-4, atol 1e-5: decode against the full
    forward, as in ``test_torch_decode.py``)."""
    cfg = get_config("smollm-135m-reduced").replace(dtype="float32")
    model, run = Model(cfg, device="cpu"), RunConfig()
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    with torch.no_grad():
        full = steps.make_prefill_step(model, run)({"tokens": tokens})
        assert torch.equal(full, model.apply({"tokens": tokens})[0])
        serve_step = steps.make_serve_step(model, run)
        cache = model.init_decode_cache(2, 6)
        for t in range(6):
            lg, cache = serve_step(cache, {"tokens": tokens[:, t], "pos": t})
            torch.testing.assert_close(lg, full[:, t], rtol=1e-4, atol=1e-5)


# -- the reference's training tests on the port ---------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-7b", "yi-6b",
                                  "zamba2-2.7b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m"])
def test_train_step_decreases_loss_and_no_nans(arch):
    """``test_arch_smoke.py``'s loss-falls test: a fixed batch repeated
    five times, lr 5e-3, no warmup."""
    cfg = get_config(arch + "-reduced").replace(dtype="float32")
    model = Model(cfg, device="cpu")
    run = RunConfig(lr=5e-3, warmup=0, total_steps=20, remat=False)
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    step = steps.make_train_step(model, opt, run, loss_chunks=2)
    rng = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    first = None
    for i in range(5):
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), (arch, i)
        first = loss if first is None else first
    assert loss < first, (arch, first, loss)
    for leaf in tree_leaves(state.params):
        assert bool(torch.isfinite(leaf).all())


def test_checkpoint_resume_bitexact(tmp_path):
    """``test_system.py``'s resume test on the port: three steps, a
    checkpoint of params and optimizer state, three more steps; the run
    restored from the checkpoint ends bit-equal."""
    cfg = get_config("gemma-7b-reduced").replace(dtype="float32")
    model = Model(cfg, device="cpu")
    run = RunConfig(lr=1e-3, warmup=0, total_steps=10, remat=False)
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    step = steps.make_train_step(model, opt, run, loss_chunks=2)
    stream = tokens.token_stream(cfg.vocab_size, 2, 32, seed=1, device="cpu")
    batches = [next(stream) for _ in range(6)]
    for b in batches[:3]:
        state, _ = step(state, b)
    save_checkpoint(str(tmp_path), 3, {"params": state.params,
                                       "opt": state.opt_state})
    sA = state
    for b in batches[3:]:
        sA, _ = step(sA, b)
    restored, at = restore_checkpoint(
        str(tmp_path), {"params": state.params, "opt": state.opt_state})
    assert at == 3
    sB = steps.TrainState(restored["params"], restored["opt"],
                          torch.tensor(3, dtype=torch.int32))
    for b in batches[3:]:
        sB, _ = step(sB, b)
    for a, b in zip(tree_leaves(sA.params), tree_leaves(sB.params)):
        assert torch.equal(a, b)


# -- checkpoints across packages -----------------------------------------------

@pytest.fixture(scope="module", params=["zamba2-2.7b", "rwkv6-1.6b",
                                        "granite-moe-1b-a400m"])
def trained(request):
    """A reference train state after one step (params, AdamState)."""
    jcfg, cfg, jmodel, params = _ref_setup(request.param)
    jrun = JaxRunConfig(**RUN)
    jopt = jax_steps.make_optimizer(jrun)
    jstate = jax_steps.TrainState(params, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    jstate, _ = jax.jit(jax_steps.make_train_step(jmodel, jopt, jrun,
                                                  loss_chunks=2))(
        jstate, next(jax_tokens.token_stream(cfg.vocab_size, 2, 32)))
    return cfg, jstate


def test_reference_checkpoint_restores_in_the_port(tmp_path, trained):
    cfg, jstate = trained
    jax_save(str(tmp_path), 7, {"params": jstate.params,
                                "opt": jstate.opt_state, "note": "ref",
                                "lr": 0.5, "n": 3})
    model, state = train_state_from_jax(
        cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    zeros = tree_map(torch.zeros_like, stack_blocks(
        {"params": state.params, "opt": state.opt_state}))
    zeros.update(note="", lr=0.0, n=0)
    got, at = restore_checkpoint(str(tmp_path), zeros)
    assert at == 7 and got["note"] == "ref" and got["lr"] == 0.5 and \
        got["n"] == 3
    for a, b in zip(tree_leaves(unstack_blocks(got["params"])),
                    tree_leaves(state.params)):
        assert torch.equal(a, b)
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
             _np(got["opt"]), jax.tree.map(np.asarray,
                                           stack_blocks(jstate.opt_state)))


def test_port_checkpoint_restores_in_the_reference(tmp_path, trained):
    cfg, jstate = trained
    _, state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    tree = {"params": stack_blocks(state.params), "opt": state.opt_state,
            "tag": "port", "eps": 1e-8, "ok": True}
    tree["opt"] = stack_blocks(tree["opt"])
    save_checkpoint(str(tmp_path), 11, tree)
    target = jax.tree.map(jnp.zeros_like, {"params": jstate.params,
                                           "opt": jstate.opt_state})
    target.update(tag="", eps=0.0, ok=False)
    got, at = jax_restore(str(tmp_path), target)
    assert at == 11 and got["tag"] == "port" and got["eps"] == 1e-8 and \
        got["ok"] is True
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(got["opt"]),
                    jax.tree.leaves(jstate.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_files_equal_the_references(tmp_path, trained):
    """The same tree written by both packages gives equal manifests (byte
    for byte) and equal arrays under equal keys."""
    _, jstate = trained
    tree = {"params": jax.tree.map(np.asarray, jstate.params), "step": 4,
            "name": "x"}
    jax_save(str(tmp_path / "ref"), 4, tree)
    save_checkpoint(str(tmp_path / "port"), 4, tree)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for fn in names:
        if fn.endswith(".msgpack"):
            assert (tmp_path / "ref" / fn).read_bytes() == \
                (tmp_path / "port" / fn).read_bytes()
        else:
            a, b = np.load(tmp_path / "ref" / fn), np.load(tmp_path / "port"
                                                           / fn)
            assert list(a.keys()) == list(b.keys())
            for k in a.keys():
                np.testing.assert_array_equal(a[k], b[k])


def test_keep_and_latest_step(tmp_path):
    for s in (1, 5, 3, 9):
        save_checkpoint(str(tmp_path), s, {"x": torch.ones(2) * s}, keep=2)
    assert latest_steps(str(tmp_path)) == [5, 9]
    assert latest_step(str(tmp_path)) == 9
    assert latest_step(str(tmp_path / "none")) is None
    got, at = restore_checkpoint(str(tmp_path), {"x": torch.zeros(2)})
    assert at == 9 and torch.equal(got["x"], torch.full((2,), 9.0))
    with pytest.raises(KeyError, match="missing leaf y"):
        restore_checkpoint(str(tmp_path), {"y": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"x": torch.zeros(2)})


MANIFESTS = [
    {"step": 3, "keys": ["a/b", "c"], "scalars": {}},
    {"step": 2 ** 40, "keys": [], "scalars": {"f": 1.5, "t": True,
                                              "n": None, "s": "é" * 40}},
    {"step": -1, "keys": ["k" * 300] * 20,
     "scalars": {"i": -200, "j": -40000, "k": 70000, "l": -(2 ** 40),
                 "m": 255, "z": 0, "neg": -32, "big": 2 ** 63,
                 "list": list(range(70000)), "map": {str(i): i
                                                     for i in range(20)}}},
]


@pytest.mark.parametrize("manifest", MANIFESTS)
def test_msgpack_subset_matches_msgpack(manifest):
    ours = _msgpack.packb(manifest)
    assert ours == msgpack.packb(manifest)
    assert _msgpack.unpackb(ours) == manifest
    assert _msgpack.unpackb(msgpack.packb(manifest)) == \
        msgpack.unpackb(msgpack.packb(manifest))


def test_msgpack_reads_float32_and_refuses_bin():
    assert _msgpack.unpackb(msgpack.packb(0.25, use_single_float=True)) \
        == 0.25
    with pytest.raises(ValueError, match="unsupported"):
        _msgpack.unpackb(msgpack.packb(b"raw"))
    with pytest.raises(TypeError, match="cannot pack"):
        _msgpack.packb(b"raw")


# -- the launchers on the CPU ----------------------------------------------------

def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b",
                                  "rwkv6-1.6b", "granite-moe-1b-a400m",
                                  "pixtral-12b"])
def test_serve_cli_on_cpu(arch):
    res = _run("repro_torch.launch.serve", "--arch", arch, "--reduced",
               "--device", "cpu", "--batch", "2", "--prompt-len", "4",
               "--gen-len", "6")
    assert res.returncode == 0, res.stderr
    assert "ms/token" in res.stdout and "tokens/s" in res.stdout
    assert "generated shape: (2, 6)" in res.stdout


def test_serve_cli_refuses_encoder_only():
    res = _run("repro_torch.launch.serve", "--arch", "hubert-xlarge",
               "--reduced", "--device", "cpu")
    assert res.returncode != 0 and "encoder-only" in res.stderr


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m", "hubert-xlarge",
                                  "pixtral-12b"])
def test_train_cli_on_cpu_writes_a_reference_checkpoint(tmp_path, arch):
    ckpt = tmp_path / "ckpt"
    res = _run("repro_torch.launch.train", "--arch", arch,
               "--reduced", "--device", "cpu", "--steps", "3", "--batch",
               "2", "--seq", "32", "--remat", "--ckpt", str(ckpt))
    assert res.returncode == 0, res.stderr
    assert "loss " in res.stdout and "checkpoint:" in res.stdout
    assert latest_step(str(ckpt)) == 3
    jcfg = jax_reduced(jax_get_config(arch)).replace(dtype="float32")
    target = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    got, at = jax_restore(str(ckpt), {"params": target})
    assert at == 3
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(target)):
        assert np.asarray(a).shape == np.asarray(b).shape
        assert np.isfinite(np.asarray(a)).all()


def test_serve_embeddings_cli_on_cpu_takes_rwkv6():
    res = _run("repro_torch.launch.serve_embeddings", "--arch",
               "rwkv6-1.6b", "--reduced", "--device", "cpu", "--seq-len",
               "32", "--corpus", "8", "--batch", "4", "--requests", "2",
               "--k", "3")
    assert res.returncode == 0, res.stderr
    assert "rwkv6-1.6b: corpus (8, 256) embedded" in res.stdout
    assert "requests/s" in res.stdout and "p99" in res.stdout


def test_serve_embeddings_cli_on_cpu_takes_moe():
    res = _run("repro_torch.launch.serve_embeddings", "--arch",
               "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
               "--seq-len", "32", "--corpus", "8", "--batch", "4",
               "--requests", "2", "--k", "3")
    assert res.returncode == 0, res.stderr
    assert "granite-moe-1b-a400m: corpus (8, 256) embedded" in res.stdout
    assert "requests/s" in res.stdout and "p99" in res.stdout


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge"])
def test_serve_embeddings_cli_on_cpu_takes_vlm_and_audio(arch):
    """The vlm and audio configs serve token batches, as the reference's
    ``embed_pool`` allows (their frames go in through the library)."""
    res = _run("repro_torch.launch.serve_embeddings", "--arch", arch,
               "--reduced", "--device", "cpu", "--seq-len", "32",
               "--corpus", "8", "--batch", "4", "--requests", "2", "--k",
               "3")
    assert res.returncode == 0, res.stderr
    assert f"{arch}: corpus (8, 256) embedded" in res.stdout
    assert "requests/s" in res.stdout and "p99" in res.stdout


def test_train_cli_refuses_the_pod_meshes():
    """Without a group of 256 (512) ranks the pod meshes are refused, as
    the reference's ``jax.make_mesh((16, 16))`` fails on fewer devices."""
    from repro_torch.launch import train
    for flags, size in ((["--production-mesh"], 256), (["--multi-pod"], 512),
                        (["--production-mesh", "--multi-pod"], 512)):
        with pytest.raises(ValueError, match=f"{size} ranks.*has 1"):
            train.main(["--arch", "smollm-135m", "--reduced", "--device",
                        "cpu", *flags])


def test_chunked_mamba2_gradient_is_finite_at_strong_decays():
    """64 SSM heads (A down to -64) and chunks of 32: above the chunk's
    diagonal the decay exponent reaches hundreds and exp overflows. The
    mask goes in before the exp, so the chunked form's gradients stay
    finite and equal the exact recurrence's: max |a - b| within 1e-3 of
    the leaf's largest |b| (the chunked form's own rtol against the
    recurrence in ``test_model_internals.py``; scaled by the leaf, since
    A_log's and dt_bias's gradients are sums that cancel)."""
    from repro_torch.models import mamba2
    cfg = get_config("zamba2-2.7b-reduced").replace(
        ssm_heads=64, ssm_chunk=32, **F32)
    gen = torch.Generator().manual_seed(0)
    p = mamba2.init_mamba2(cfg, gen)
    p["dt_bias"] = torch.full_like(p["dt_bias"], 1.0)    # dt ~ 1.3
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    grads = []
    for fn in (mamba2.apply_mamba2, mamba2.apply_mamba2_ref):
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        fn(live, xl, cfg).square().sum().backward()
        grads.append([xl.grad] + [live[k].grad for k in sorted(live)])
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_lm_training_learns_structure():
    """``test_system.py``'s learns-structure test on the port: reduced
    smollm-135m on the Markov token stream, 80 steps; the mean loss of
    the last 5 under 0.85 x the first 5."""
    cfg = get_config("smollm-135m-reduced").replace(dtype="float32")
    model = Model(cfg, device="cpu")
    run = RunConfig(lr=3e-3, warmup=5, total_steps=80, remat=False)
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    step = steps.make_train_step(model, opt, run, loss_chunks=2)
    stream = tokens.token_stream(cfg.vocab_size, 8, 64, seed=0, device="cpu")
    losses = []
    for _ in range(80):
        state, m = step(state, next(stream))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < 0.85 * np.mean(losses[:5])
