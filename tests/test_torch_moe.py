"""The port's moe family held against the JAX reference's.

One numpy seed feeds both packages; the reference's parameters
(``init_moe`` / ``Model.init`` from a PRNG key) come across as numpy
arrays (``convert.model_params_from_jax`` for whole models).
``granite-moe-1b-a400m-reduced`` (d_model 256, 4 experts, top 2, expert
d_ff 512, 2 layers) and ``qwen3-moe-30b-a3b-reduced`` (the same with
``qk_norm``), f32; the router's tie tests also run at the full configs'
32 and 128 experts, top 8.

Tolerances. Port against reference on the same form: the same
operations in the same order of casts, only the summation order of the
products differs: rtol 1e-4, atol 1e-5 (the port's ``SAME_TOL``).
Routing (``topi``) and the queue places (``keep``, ``dest``) are
integers and must be equal: exactly where probabilities tie, and
wherever the k-th and (k+1)-th probabilities are apart by more than
1e-6 (the f32 difference of two summation orders is far below).
Gradients: max |a - b| within 1e-4 of the leaf's largest |b| (router
gradients are sums that cancel). Grouped against the dense oracle: the
reference's own bound (rtol 1e-3, atol 1e-4; ``TestMoE``). bf16
activations: ``topi`` equal, y within rtol 2e-2, atol 2e-2 (bf16
rounding of the products and the slot-by-slot combine).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import Model, moe

SAME_TOL = dict(rtol=1e-4, atol=1e-5)
DENSE_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_REL = 1e-4
GAP = 1e-6
NAMES = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
B, T = 2, 32


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _cfgs(name, **over):
    jcfg = jax_reduced(jax_get_config(name)).replace(dtype="float32", **over)
    cfg = get_config(name + "-reduced").replace(dtype="float32", **over)
    return jcfg, cfg


def _layer(jcfg, seed=0, skew=False):
    """The reference's MoE params and the same as tensors. ``skew``
    points experts 0 and 1 along the all-ones direction, which ``_x``
    carries, so every token routes to them and their queues overflow."""
    jp = {k: np.asarray(v) for k, v in
          jax_moe.init_moe(jcfg, jax.random.PRNGKey(seed)).items()}
    if skew:
        jp["router"] = jp["router"].copy()
        d = jp["router"].shape[0]
        jp["router"][:, 0] += 0.5 / np.sqrt(d)
        jp["router"][:, 1] += 0.4 / np.sqrt(d)
    return jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _x(d, seed=1, skew=False, shape=(B, T)):
    x = np.random.RandomState(seed).randn(*shape, d).astype(np.float32)
    return x + 2.0 if skew else x


def _ref_slots(topi, e_offset, n_local, capacity):
    """The reference ``_moe_local``'s queue places (its expression,
    ``src/repro/models/moe.py`` ``_moe_local``) on its own routing."""
    local_e = topi - e_offset
    is_local = (local_e >= 0) & (local_e < n_local)
    flat_e = jnp.where(is_local, local_e, n_local).reshape(-1)
    onehot = jax.nn.one_hot(flat_e, n_local + 1, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.sum(pos_in_e * onehot, axis=1)
    keep = (slot < capacity) & (flat_e < n_local)
    dest = jnp.where(keep, flat_e * capacity + slot, n_local * capacity)
    return np.asarray(keep), np.asarray(dest)


# -- the router -----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(name, dtype):
    jcfg, cfg = _cfgs(name)
    jp, p = _layer(jcfg, seed=2)
    x = _x(cfg.d_model, seed=3, shape=(B * T,))
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jv, ji, ja = jax_moe._route(jnp.asarray(jp["router"]),
                                jnp.asarray(x, jdt), jcfg)
    v, i, a = moe._route(p["router"], torch.from_numpy(x).to(dt), cfg)
    assert i.shape == ji.shape and v.dtype == torch.float32
    probs = np.sort(np.asarray(jax.nn.softmax(
        (jnp.asarray(x, jdt) @ jnp.asarray(jp["router"], jdt)).astype(
            jnp.float32), -1)), -1)[:, ::-1]
    apart = probs[:, cfg.top_k - 1] - probs[:, cfg.top_k] > GAP
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[apart], np.asarray(ji)[apart])
    _close(v, jv, **SAME_TOL)
    _close(a, ja, **SAME_TOL)


@pytest.mark.parametrize("name,full", [("granite-moe-1b-a400m", False),
                                       ("granite-moe-1b-a400m", True),
                                       ("qwen3-moe-30b-a3b", True)])
def test_route_breaks_ties_as_the_reference(name, full):
    """Ties go to the lower expert index, as ``jax.lax.top_k``'s do
    (``torch.topk`` returns [2, 3] of four equal probabilities): a zero
    router ties every expert; a router whose columns come in equal
    pairs ties each pair's bf16 logits exactly."""
    jcfg, cfg = _cfgs(name)
    if full:
        jcfg = jax_get_config(name).replace(d_model=64)
        cfg = get_config(name).replace(d_model=64)
    d, E = cfg.d_model, cfg.n_experts
    x = _x(d, seed=4, shape=(24,))
    base = np.random.RandomState(5).randn(d, E // 2).astype(np.float32)
    routers = {"zero": np.zeros((d, E), np.float32),
               "pairs": np.repeat(0.02 * base, 2, axis=1)}
    for kind, r in routers.items():
        for jdt, dt in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
            _, ji, _ = jax_moe._route(jnp.asarray(r), jnp.asarray(x, jdt),
                                      jcfg)
            _, i, _ = moe._route(torch.from_numpy(r),
                                 torch.from_numpy(x).to(dt), cfg)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        if kind == "zero":
            assert (i.numpy() == np.arange(cfg.top_k)).all()


@pytest.mark.parametrize("experts", [(4, 2), (32, 8), (128, 8), (60, 4)])
@pytest.mark.parametrize("factor", [None, 0.25, 1.25, 3.3])
def test_capacity_matches_reference(experts, factor):
    E, k = experts
    jcfg = jax_get_config("granite-moe-1b-a400m").replace(n_experts=E,
                                                          top_k=k)
    cfg = get_config("granite-moe-1b-a400m").replace(n_experts=E, top_k=k)
    for n_tokens in (1, 4, 7, 48, 188, 1000, 2048, 32768):
        for n_local in (E, max(1, E // 4)):
            got = moe._capacity(n_tokens, cfg, n_local, factor)
            assert got == jax_moe._capacity(n_tokens, jcfg, n_local, factor)
            assert got >= 8 and got % 8 == 0


# -- the grouped layer ----------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("e_offset,n_local", [(0, 4), (1, 2), (2, 2)])
@pytest.mark.parametrize("capacity", [8, 24, 72])
def test_queue_slots_match_reference(name, e_offset, n_local, capacity):
    """``_queue_slots`` on one routing equals the reference's queue
    places bit for bit, local shards and overflowing queues included."""
    jcfg, cfg = _cfgs(name)
    _, p = _layer(jcfg, seed=6, skew=True)
    x = torch.from_numpy(_x(cfg.d_model, seed=7, skew=True,
                            shape=(B * T,)))
    _, topi, _ = moe._route(p["router"], x, cfg)
    keep, dest = moe._queue_slots(topi, e_offset, n_local, capacity)
    rkeep, rdest = _ref_slots(jnp.asarray(topi.numpy()), e_offset, n_local,
                              capacity)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    np.testing.assert_array_equal(dest.numpy(), rdest)
    assert dest.max() <= n_local * capacity


@pytest.fixture(scope="module", params=[(n, f) for n in NAMES
                                        for f in ("config", "overflow")],
                ids=lambda v: f"{v[0]}-{v[1]}")
def grouped(request):
    """Both packages' grouped layer on one input: at the config's
    capacity factor, and with the skewed router at factor 0.25, where
    the queues of experts 0 and 1 overflow."""
    name, case = request.param
    over = {} if case == "config" else dict(moe_capacity_factor=0.25)
    jcfg, cfg = _cfgs(name, **over)
    skew = case == "overflow"
    jp, p = _layer(jcfg, seed=8, skew=skew)
    x = _x(cfg.d_model, seed=9, skew=skew)
    return {"case": case, "jcfg": jcfg, "cfg": cfg, "jp": jp, "p": p,
            "x": x}


def test_grouped_keep_and_dest_equal_reference(grouped):
    g, cfg = grouped, grouped["cfg"]
    N = B * T
    cap = moe._capacity(N, cfg, cfg.n_experts)
    xf = g["x"].reshape(N, -1)
    _, ji, _ = jax_moe._route(jnp.asarray(g["jp"]["router"]),
                              jnp.asarray(xf), g["jcfg"])
    _, i, _ = moe._route(g["p"]["router"], torch.from_numpy(xf), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    keep, dest = moe._queue_slots(i, 0, cfg.n_experts, cap)
    rkeep, rdest = _ref_slots(ji, 0, cfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    np.testing.assert_array_equal(dest.numpy(), rdest)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (g["case"] == "overflow"), dropped


def test_moe_local_and_apply_moe_match_reference(grouped):
    g, cfg, jcfg = grouped, grouped["cfg"], grouped["jcfg"]
    N = B * T
    cap = moe._capacity(N, cfg, cfg.n_experts)
    xf = g["x"].reshape(N, -1)
    jy, ja = jax_moe._moe_local({k: jnp.asarray(v) for k, v in
                                 g["jp"].items()}, jnp.asarray(xf), jcfg,
                                0, cfg.n_experts, cap)
    y, a = moe._moe_local(g["p"], torch.from_numpy(xf), cfg, 0,
                          cfg.n_experts, cap)
    _close(y, jy, **SAME_TOL)
    _close(a, ja, **SAME_TOL)
    jy, ja = jax_moe.apply_moe(g["jp"], jnp.asarray(g["x"]), jcfg)
    y, a = moe.apply_moe(g["p"], torch.from_numpy(g["x"]), cfg)
    assert y.shape == (B, T, cfg.d_model) and y.dtype == torch.float32
    _close(y, jy, **SAME_TOL)
    _close(a, ja, **SAME_TOL)


def test_apply_moe_gradients_match_reference(grouped):
    """Port autograd against ``jax.grad`` of <y, cot> + 0.5 aux with a
    seeded cotangent: x and every leaf (the router's through both the
    renormalised top-k weights and the aux loss)."""
    g, cfg, jcfg = grouped, grouped["cfg"], grouped["jcfg"]
    cot = np.random.RandomState(10).randn(*g["x"].shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jax_moe.apply_moe(p, x, jcfg)
        return jnp.sum(y * cot) + 0.5 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in g["jp"].items()}, jnp.asarray(g["x"]))
    p = {k: v.clone().requires_grad_(True) for k, v in g["p"].items()}
    x = torch.from_numpy(g["x"]).requires_grad_(True)
    y, aux = moe.apply_moe(p, x, cfg)
    (torch.sum(y * torch.from_numpy(cot)) + 0.5 * aux).backward()
    pairs = [(x.grad, jgx)] + [(p[k].grad, jgp[k]) for k in sorted(p)]
    for a, b in pairs:
        b = np.asarray(b)
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert np.abs(b).max() > 0
        _close(a, b, rtol=0, atol=GRAD_REL * np.abs(b).max())


def test_named_mesh_still_refuses():
    """A named shape has no process group: its per-rank program runs in
    a fake world (``launch/mesh.fake_world``), which the error names. A
    live mesh runs the layer expert-parallel
    (tests/test_torch_multirank_moe.py)."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    _, p = _layer(jcfg)
    for mesh in (make_local_mesh(), make_production_mesh()):
        with pytest.raises(NotImplementedError, match="fake_world"):
            moe.apply_moe(p, torch.zeros((1, 4, cfg.d_model)), cfg,
                          mesh=mesh)


@pytest.mark.parametrize("name", NAMES)
def test_model_refuses_a_named_mesh(name):
    """The moe ``Model`` refuses a named mesh once, where its forward
    and decode start (its per-rank program on a named mesh runs in a
    fake world, which the error names)."""
    cfg = get_config(name + "-reduced").replace(dtype="float32")
    model = Model(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for mesh in (make_local_mesh(), make_production_mesh()):
        with pytest.raises(NotImplementedError, match="fake_world"):
            model.hidden({"tokens": tokens}, mesh=mesh)
        with pytest.raises(NotImplementedError, match="fake_world"):
            model.apply({"tokens": tokens}, mesh=mesh)
        with pytest.raises(NotImplementedError, match="fake_world"):
            model.decode_step(model.init_decode_cache(1, 4), tokens[:, 0],
                              0, mesh=mesh)


# -- the dense oracle -------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_apply_moe_dense_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    jp, p = _layer(jcfg, seed=11)
    x = _x(cfg.d_model, seed=12)
    jy, ja = jax_moe.apply_moe_dense(jp, jnp.asarray(x), jcfg)
    y, a = moe.apply_moe_dense(p, torch.from_numpy(x), cfg)
    _close(y, jy, **SAME_TOL)
    _close(a, ja, **SAME_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_grouped_equals_dense_when_capacity_ample(name):
    """The reference's ``TestMoE`` test of the same name, on the port."""
    _, cfg = _cfgs(name)
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 16, cfg.d_model).astype(np.float32))
    y_g, aux_g = moe.apply_moe(p, x, cfg)
    y_d, aux_d = moe.apply_moe_dense(p, x, cfg)
    _close(y_g, y_d, **DENSE_TOL)
    np.testing.assert_allclose(float(aux_g), float(aux_d), rtol=1e-4)


def test_aux_loss_uniform_router_is_one():
    """The reference's ``TestMoE`` test of the same name, on the port:
    a zero router ties every expert, and the stable top-k spreads
    nothing, yet the loss stays near 1."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 64, cfg.d_model).astype(np.float32))
    _, aux = moe.apply_moe(p, x, cfg)
    assert 0.9 < float(aux) < 1.3


@pytest.mark.parametrize("name", NAMES)
def test_bf16_grouped_and_dense_match_reference(name):
    jcfg, cfg = _cfgs(name)
    jcfg, cfg = jcfg.replace(dtype="bfloat16"), cfg.replace(dtype="bfloat16")
    jp, p = _layer(jcfg, seed=13)
    x = _x(cfg.d_model, seed=14)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jxb = jnp.asarray(x, jnp.bfloat16)
    _, ji, _ = jax_moe._route(jnp.asarray(jp["router"]),
                              jxb.reshape(B * T, -1), jcfg)
    _, i, _ = moe._route(p["router"], xb.reshape(B * T, -1), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    for jfn, fn in ((jax_moe.apply_moe, moe.apply_moe),
                    (jax_moe.apply_moe_dense, moe.apply_moe_dense)):
        jy, ja = jfn(jp, jxb, jcfg)
        y, a = fn(p, xb, cfg)
        assert y.dtype == torch.bfloat16
        _close(y.to(torch.float32), np.asarray(jy, np.float32), **BF16_TOL)
        _close(a, ja, **SAME_TOL)


# -- the moe Model ----------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jcfg, cfg = _cfgs(name)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = model_params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    h, aux = jmodel.hidden(params, jbatch)
    ref = {"hidden": h, "moe_aux": aux["moe_aux"],
           "apply": jmodel.apply(params, jbatch)[0],
           "embed_pool": jmodel.embed_pool(params, jbatch)}
    return params, model, {"tokens": torch.from_numpy(tokens)}, ref


@pytest.mark.parametrize("fn", ["hidden", "apply", "embed_pool"])
@pytest.mark.parametrize("plain", [False, True])
def test_model_matches_reference(pair, fn, plain):
    _, model, batch, ref = pair
    out = getattr(model, fn)(batch, plain=plain)
    if isinstance(out, tuple):
        out, aux = out
        assert float(aux["moe_aux"]) > 0
        _close(aux["moe_aux"], ref["moe_aux"], **SAME_TOL)
    assert out.shape == ref[fn].shape and out.dtype == torch.float32
    _close(out, ref[fn], **SAME_TOL)


def test_params_and_count_equal_reference(pair):
    params, model, _, _ = pair
    cfg = model.cfg
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(params))
    for i, block in enumerate(model.blocks):
        assert not hasattr(block, "mlp")
        for leaf in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                block["moe"][leaf].numpy(),
                np.asarray(params["blocks"]["moe"][leaf])[i])
    assert tuple(model.blocks[0]["moe"]["w_down"].shape) == (
        cfg.n_experts, cfg.d_ff, cfg.d_model)
    seeded = Model(cfg, device="cpu", seed=3)
    assert sum(p.numel() for p in seeded.parameters()) == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", NAMES)
def test_future_tokens_do_not_leak(name):
    """``tests/test_causality.py``'s check on the port."""
    cfg = get_config(name + "-reduced").replace(dtype="float32")
    model = Model(cfg, device="cpu")
    rng = np.random.RandomState(0)
    Bc, Tc, cut = 2, 24, 11
    toks = rng.randint(0, cfg.vocab_size, (Bc, Tc)).astype(np.int32)
    toks2 = toks.copy()
    toks2[:, cut:] = rng.randint(0, cfg.vocab_size, (Bc, Tc - cut))
    with torch.no_grad():
        la, _ = model.apply({"tokens": torch.from_numpy(toks)})
        lb, _ = model.apply({"tokens": torch.from_numpy(toks2)})
    _close(la[:, :cut], lb[:, :cut], rtol=1e-4, atol=1e-4)
    assert float((la[:, cut:] - lb[:, cut:]).abs().max()) > 1e-4


def test_remat_carries_aux():
    """The moe loss through ``hidden(remat=True)`` equals the loss
    without remat, and so do its gradients (the checkpointed layer
    returns (x, aux))."""
    cfg = get_config("granite-moe-1b-a400m-reduced").replace(
        dtype="float32")
    model = Model(cfg, device="cpu", seed=1)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out = []
    for remat in (False, True):
        params = {k: v for k, v in model.param_tree().items()}
        leaves = params["blocks"][0]["moe"]
        live = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        params["blocks"] = [dict(params["blocks"][0], moe=live)] + \
            params["blocks"][1:]
        h, aux = model.hidden({"tokens": tokens}, plain=True, remat=remat,
                              params=params)
        (h.square().mean() + aux["moe_aux"]).backward()
        out.append((float(aux["moe_aux"].detach()), {k: v.grad for k, v in
                                            live.items()}))
    assert out[0][0] == out[1][0] and out[0][0] > 0
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], rtol=1e-6,
                                   atol=1e-9)


def test_full_width_init_routes_unevenly_in_both_packages():
    """granite-moe's layer 0 at full width (one layer, B 1, T 256, the
    card's tokens; ``tests/_moe_load.py``): the port routes the
    reference's weights exactly as the reference does, and both
    packages' seeded inits load some expert past the capacity at the
    config's factor 2, so pairs drop at the init in the reference too."""
    from _moe_load import layer0_routes, summary
    ref, same, own, cfg = layer0_routes(256)
    np.testing.assert_array_equal(same, ref)
    for topi in (ref, own):
        load = summary(topi, cfg)
        assert load["max"] > load["capacity"] and load["dropped"] > 0, load
