"""The port's backbones held against the JAX reference's ``Model``.

The reference's parameters (``Model.init`` from a PRNG key) are carried
across with ``convert.model_params_from_jax``, token ids come from a
numpy seed, and both sides run in f32. Reduced zamba2 (2 mamba2 layers,
one group with the shared attention block, window 64, T = 128), reduced
smollm-135m (GQA 4 / 2) and reduced gemma-7b (2 layers, 4 heads of 256:
its head dim kept). Tolerances: the port's kernel path
runs the SSD core in chunks of 64 where the reference's ``Model`` runs
its chunked ``apply_mamba2`` (chunk 32 here), so zamba2 gets the
reference's own bound between those forms (rtol 2e-3, atol 2e-4); the
plain path and the dense model take the same forms as the reference
(rtol 1e-4, atol 1e-5). Also: every config equals the reference's,
the GELU is the tanh form and RoPE rotates halves, every config of the
registry builds a model with the reference's parameter count, and the
embedding service runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp

from repro_torch.configs import get_config, list_configs
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels._dispatch import topk_by_distance
from repro_torch.launch import serve_embeddings
from repro_torch.models import Model, common, mlp
from repro_torch.models.transformer import FAMILIES

F32 = dict(dtype="float32", ssm_tile_dtype="float32", ssm_chunk=32)
SSD_TOL = dict(rtol=2e-3, atol=2e-4)
SAME_TOL = dict(rtol=1e-4, atol=1e-5)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("name", jax_list_configs())
def test_configs_equal_reference(name):
    assert list_configs() == jax_list_configs()
    for suffix in ("", "-reduced"):
        assert dataclasses.asdict(get_config(name + suffix)) == \
            dataclasses.asdict(jax_get_config(name + suffix))


# -- whole models ---------------------------------------------------------------

# reduced gemma-7b keeps its head dim of 256 (GeGLU, embedding scaling,
# tied embeddings): the shape of the Dh-256 attention kernel on the card
HEAD_DIM = {"gemma-7b": dict(head_dim=256)}


@pytest.fixture(scope="module",
                params=["zamba2-2.7b", "smollm-135m", "gemma-7b"])
def pair(request):
    name = request.param
    extra = HEAD_DIM.get(name, {})
    jcfg = jax_reduced(jax_get_config(name)).replace(**F32, **extra)
    cfg = get_config(name + "-reduced").replace(**F32, **extra)
    assert cfg.dim_per_head == jcfg.dim_per_head
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = model_params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    ref = {"hidden": jmodel.hidden(params, jbatch)[0],
           "apply": jmodel.apply(params, jbatch)[0],
           "embed_pool": jmodel.embed_pool(params, jbatch)}
    return name, params, model, {"tokens": torch.from_numpy(tokens)}, ref


@pytest.mark.parametrize("fn", ["hidden", "apply", "embed_pool"])
@pytest.mark.parametrize("plain", [False, True])
def test_model_matches_reference(pair, fn, plain):
    name, _, model, batch, ref = pair
    out = getattr(model, fn)(batch, plain=plain)
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == ref[fn].shape and out.dtype == torch.float32
    tol = SSD_TOL if name.startswith("zamba2") and not plain else SAME_TOL
    _close(out, ref[fn], **tol)


def test_params_carried_bit_for_bit(pair):
    name, params, model, _, _ = pair
    cfg = model.cfg
    assert len(model.blocks) == cfg.n_layers
    np.testing.assert_array_equal(model.embedding.tok.numpy(),
                                  np.asarray(params["embedding"]["tok"]))
    leaf = ("mamba", "w_xbc") if cfg.family == "hybrid" else ("attn", "wq")
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(
            block[leaf[0]][leaf[1]].numpy(),
            np.asarray(params["blocks"][leaf[0]][leaf[1]])[i])
    if cfg.shared_attn_every:
        np.testing.assert_array_equal(
            model.shared["mlp"]["w_up"].numpy(),
            np.asarray(params["shared"]["mlp"]["w_up"]))
    names = dict(model.named_parameters())
    assert all(not p.requires_grad for p in names.values())
    assert ("blocks.0.mamba.A_log" in names) == (cfg.family == "hybrid")


def test_seeded_init_is_deterministic():
    cfg = get_config("zamba2-2.7b-reduced")
    a = Model(cfg, device="cpu", seed=3)
    b = Model(cfg, device="cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert ka == kb and torch.equal(va, vb)
    n = sum(p.numel() for p in a.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(
        jax_build_model(jax_reduced(jax_get_config("zamba2-2.7b"))).init(
            jax.random.PRNGKey(0))))


@pytest.mark.parametrize("name", jax_list_configs())
def test_every_config_builds_a_model(name):
    """Every config of the registry, each of the six families, builds a
    ``Model`` on the CPU at its reduction, with the reference's
    parameter count."""
    cfg = get_config(name + "-reduced")
    model = Model(cfg, device="cpu")
    assert cfg.family in FAMILIES and model.device.type == "cpu"
    assert len(model.blocks) == cfg.n_layers
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(jax_build_model(jax_reduced(jax_get_config(
        name))).init, jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


# -- building blocks ----------------------------------------------------------

def test_gelu_is_the_tanh_form():
    cfg = get_config("zamba2-2.7b-reduced").replace(dtype="float32")
    jcfg = jax_reduced(jax_get_config("zamba2-2.7b")).replace(
        dtype="float32", mlp_kind="gelu")
    jp = jax_mlp.init_mlp(jcfg, jax.random.PRNGKey(4))
    p = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in jp.items()}
    x = np.random.RandomState(4).randn(2, 8, cfg.d_model).astype(np.float32)
    ref = jax_mlp.apply_mlp(jp, jnp.asarray(x), jcfg)
    out = mlp.apply_mlp(p, torch.from_numpy(x), cfg.replace(mlp_kind="gelu"))
    _close(out, ref, rtol=1e-5, atol=1e-5)
    z = torch.linspace(-4, 4, 101)
    _close(mlp.gelu_tanh(z), jax.nn.gelu(jnp.asarray(z.numpy())),
           rtol=1e-6, atol=1e-6)
    assert (mlp.gelu_tanh(z) - F.gelu(z)).abs().max() > 1e-4


def test_rope_rotates_halves():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    ref = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0)
    _close(out, ref, rtol=1e-5, atol=1e-5)
    # the rotation pairs dim i with dim i + Dh/2, not with i + 1
    e = np.zeros((1, 2, 1, 16), np.float32)
    e[0, 1, 0, 0] = 1.0
    rot = common.apply_rope(torch.from_numpy(e), torch.tensor([[0, 1]]),
                            10000.0)[0, 1, 0]
    assert rot[8] != 0 and rot[1] == 0


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    cfg = get_config("smollm-135m-reduced").replace(norm_kind=kind)
    jcfg = jax_reduced(jax_get_config("smollm-135m")).replace(norm_kind=kind)
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5, cfg.d_model).astype(np.float32)
    p = {"scale": rng.rand(cfg.d_model).astype(np.float32),
         "bias": rng.randn(cfg.d_model).astype(np.float32)}
    ref = jax_common.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jcfg)
    out = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    _close(out, ref, rtol=1e-5, atol=1e-5)


# -- the embedding service ----------------------------------------------------

def test_serve_embeddings_cli_on_cpu(capsys):
    out = serve_embeddings.main(["--device", "cpu", "--reduced",
                                 "--seq-len", "24", "--corpus", "12",
                                 "--batch", "4", "--requests", "2",
                                 "--k", "3"])
    text = capsys.readouterr().out
    assert "requests/s" in text and "p99" in text
    assert out["corpus_emb"].shape == (12, 256)
    assert out["ids"].shape == (8, 3) and len(out["batch_ms"]) == 2
    assert bool(torch.isfinite(out["dists"]).all())


def test_serve_ranks_by_distance_then_id():
    model, L = serve_embeddings.build("smollm-135m", reduced=True,
                                      device="cpu", proj_dim=16)
    rng = np.random.RandomState(0)
    corpus = serve_embeddings.token_batches(model.cfg.vocab_size, 10, 16, 4,
                                            rng)
    # request rows equal to corpus rows 3 and 7: each must find itself
    req = [np.stack([corpus[0][3], corpus[1][3]])]
    out = serve_embeddings.serve(model, L, corpus, req, k=4)
    assert out["ids"][:, 0].tolist() == [3, 7]
    emb = out["corpus_emb"]
    D = ((emb[[3, 7]] - emb[:, None]) @ L.T).square().sum(-1).T
    d, i = topk_by_distance(D, torch.arange(10, dtype=torch.int32)
                            .expand(2, -1), 4)
    assert torch.equal(i, out["ids"])
    _close(out["dists"], d, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="k=11"):
        serve_embeddings.serve(model, L, corpus, req, k=11)
