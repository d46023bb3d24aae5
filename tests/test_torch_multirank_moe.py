"""The expert-parallel moe, the pod meshes, sharded checkpoint restore and
the closed loop over a worker mesh, on 4 gloo ranks on the CPU, held
against the JAX reference and the port's one-process oracle.

One module-scoped ``launch/mesh.spawn`` of 4 ranks runs every rank-side
case (``tests/_multirank_moe_ranks.py``, which imports no jax), while a
JAX subprocess on 4 forced host devices (this file run as a script)
computes the reference's answers from the same numpy inputs:

  * the collectives' gradients against hand values: ``psum`` passes the
    replicated cotangent through, ``pmean`` divides it by 4,
    ``all_gather`` (stacked and tiled) reduce-scatters a partial one,
    and ``shard_map``'s entry sums a sharded and a replicated input's
    gradients over the ranks while its exit gathers;
  * ``moe.apply_moe(mesh=)`` on (data, model) = (1, 4), (2, 2) and
    (4, 1), reduced granite-moe (d 256, 4 experts, top 2) in f32: y, aux
    and the gradients of sum(y * cot) + 3 aux with respect to the
    router, the three expert stacks and x, against the reference's
    ``jax.set_mesh`` + ``jax.jit(jax.grad)`` on the same mesh; on a live
    mesh without the expert axis the layer is the one-device layer, bit
    for bit;
  * ``Model.apply(mesh=)`` on the three meshes against the reference's
    jitted ``Model.apply(mesh=)``; ``decode_step(mesh=)`` (through
    ``steps.make_serve_step``) at B = 1 on (1, 4) and (2, 2) against
    the reference's one-device decode: its decode with a mesh fails
    under jax 0.9.0 (a ``dynamic_update_slice`` sharding error), and at
    B = 1 the batch axes are idle, so the expert-parallel layer routes
    and keeps exactly what one device does;
  * one ``steps.make_train_step(mesh=)`` AdamW step on (2, 2): the loss,
    its parts, the gradient norm and every gradient leaf against the
    one-device oracle, the mean over the two batch halves of ce +
    ``moe_aux_weight`` * aux, each half through the one-process model
    (the reference's whole-model gradient with a mesh fails under jax
    0.9.0); after the step every rank's parameters are bit-identical;
  * ``restore_checkpoint(shardings=)`` on (2, 2): each rank's leaves
    equal the reference's addressable shard on the device at the same
    mesh coordinates (``jax.device_put`` under the same specs);
  * the production-mesh rule of ``launch/train.py`` at world sizes 4,
    256 and 512;
  * ``ClosedLoopTrainer(mesh=)`` at P = 4 over ranks (mutable-exact, a
    refresh every 10 of 30 steps) against the reference's P = 4 loop on
    its 4-device worker mesh: equal refresh records and pools, losses
    and L within rtol 1e-5, atol 1e-6; every rank returns the same.

Tolerances. The same f32 forms in another summation order: y and logits
within rtol 1e-5, atol 1e-5 x max |ref|; aux within 1e-6; every gradient
leaf within GRAD_REL = 1e-4 of the leaf's largest |ref| (router
gradients are sums that cancel; test_torch_moe.py's bound); the train
step's loss and gradient norm within rtol 1e-5.
"""

import os
import pickle
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import dml as jax_dml
from repro.core.ps import sync as jax_sync
from repro.core.ps.trainer import DMLTrainConfig as JaxTrainConfig
from repro.data import pairs as jax_pairs
from repro.mining import ClosedLoopConfig as JaxLoopConfig
from repro.mining import ClosedLoopTrainer as JaxLoop
from repro.mining import CurriculumSchedule as JaxSchedule
from repro.mining import MinerConfig as JaxMinerConfig
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe

import _multirank_moe_ranks as ranks
from test_torch_closed_loop import _assert_same_runs
from repro_torch.convert import closed_loop_config_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.sharding import partition
from repro_torch.tree import tree_leaves, value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = ranks.N_RANKS
GRAD_REL = 1e-4
B, T = 4, 16
LOOP_P = 4


def _jcfg():
    return jax_reduced(jax_get_config(ranks.ARCH)).replace(dtype="float32")


def _loop_jcfg():
    """test_torch_closed_loop.py's recipe at P = 4: mutable-exact, a
    refresh every 10 of 30 steps, 64 pairs a worker a step."""
    return JaxLoopConfig(
        train=JaxTrainConfig(dml=jax_dml.DMLConfig(feat_dim=16, proj_dim=8),
                             ps=jax_sync.PSConfig(n_workers=LOOP_P),
                             batch_size=64, steps=30, lr=1e-2, log_every=1),
        miner=JaxMinerConfig(k_neighbors=10),
        schedule=JaxSchedule(warmup_steps=4, ramp_steps=8,
                             max_mined_frac=0.5),
        mine_queries=128, index="mutable-exact", refresh_every=10)


def _loop_data():
    return jax_pairs.make_features(jax_pairs.PairDatasetConfig(
        n_samples=400, feat_dim=16, n_classes=6, kind="class_blobs",
        noise=0.3, seed=0))


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=rel * float(np.abs(b).max()))


def _grad_close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert float(np.abs(a - b).max()) <= \
        GRAD_REL * float(np.abs(b).max()) + 1e-12


# -- the reference: 4 forced host devices, in a subprocess --------------------

def _reference(inp_path, out_path):
    assert jax.device_count() == N, jax.device_count()
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    jcfg = _jcfg()
    out = {"layer": {}, "apply": {}, "restore": {}}
    p = {k: jnp.asarray(v) for k, v in inp["layer_p"].items()}
    x, cot = jnp.asarray(inp["layer_x"]), jnp.asarray(inp["layer_cot"])
    for name, shape in ranks.SHAPES.items():
        mesh = jax.make_mesh(shape, ("data", "model"))

        def loss(p, x, mesh=mesh):
            y, aux = jax_moe.apply_moe(p, x, jcfg, mesh=mesh)
            return jnp.sum(y * cot) + ranks.AUX_W * aux

        with jax.set_mesh(mesh):
            y, aux = jax.jit(lambda p, x, mesh=mesh: jax_moe.apply_moe(
                p, x, jcfg, mesh=mesh))(p, x)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        out["layer"][name] = {
            "y": np.asarray(y), "aux": float(aux), "grad_x": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}
    model = jax_build_model(jcfg)
    params = jax.tree.map(jnp.asarray, inp["model_params"])
    tokens = jnp.asarray(inp["tokens"])
    for name, shape in ranks.SHAPES.items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        logits, aux = jax.jit(lambda p, t, mesh=mesh: model.apply(
            p, {"tokens": t}, mesh=mesh))(params, tokens)
        out["apply"][name] = {"logits": np.asarray(logits),
                              "moe_aux": float(aux["moe_aux"])}
    cache = model.init_decode_cache(1, ranks.DECODE_STEPS)
    decode = []
    for t in range(ranks.DECODE_STEPS):
        logits, cache = model.decode_step(params, cache, tokens[:1, t],
                                          jnp.int32(t))
        decode.append(np.asarray(logits))
    out["decode"] = np.stack(decode)
    # restore under the port's specs (equal to the reference's plan,
    # test_torch_sharding.py) as NamedShardings on a (2, 2) mesh
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    shardings = {"params": partition.map_specs(
        lambda s: JaxNamedSharding(mesh, P(*s)), inp["ckpt_specs"])}
    target = {"params": jax.tree.map(
        lambda s: np.zeros(s, np.float32), inp["ckpt_shapes"],
        is_leaf=lambda s: isinstance(s, tuple))}
    tree, step = jax_restore(inp["ckpt_dir"], target, shardings=shardings)
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    for rank in range(N):
        dev = mesh.devices[divmod(rank, 2)]
        out["restore"][rank] = {
            jax.tree_util.keystr(path): np.asarray(next(
                s.data for s in leaf.addressable_shards if s.device == dev))
            for path, leaf in leaves}
    out["restore_step"] = step
    x_loop, y_loop = _loop_data()
    jt = JaxLoop(_loop_jcfg(), x_loop, y_loop)
    Lj, hj = jt.run()
    out["loop"] = {"L": np.asarray(Lj), "hist": hj,
                   "pool": {k: np.asarray(v)
                            for k, v in jt.source._pool.items()}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# -- inputs, the two runs -----------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    jcfg = _jcfg()
    rng = np.random.RandomState(0)
    layer_p = jax.tree.map(np.asarray,
                           jax_moe.init_moe(jcfg, jax.random.PRNGKey(1)))
    model_params = jax.tree.map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    inp = {"layer_p": layer_p,
           "layer_x": rng.randn(B, T, jcfg.d_model).astype(np.float32),
           "layer_cot": rng.randn(B, T, jcfg.d_model).astype(np.float32),
           "model_params": model_params,
           "tokens": rng.randint(0, jcfg.vocab_size, (B, T)).astype(
               np.int32),
           "labels": rng.randint(0, jcfg.vocab_size, (B, T)).astype(
               np.int32)}
    # a checkpoint of the port's (unstacked) parameter tree in the
    # reference's files, and the plan's specs for it on (2, 2)
    tree = ranks.model_from(inp).param_tree()
    shape22 = mesh_lib.Mesh(("data", "model"), (2, 2))
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    jax_save(ckpt_dir, 7, {"params": jax.tree.map(
        lambda t: t.numpy(), tree, is_leaf=torch.is_tensor)})
    inp["ckpt_dir"] = ckpt_dir
    inp["ckpt_specs"] = partition.make_param_shardings(
        ranks.model_from(inp).logical_axes(), shape22, tree)
    inp["ckpt_shapes"] = jax.tree.map(lambda t: tuple(t.shape), tree,
                                      is_leaf=torch.is_tensor)
    jloop = _loop_jcfg()
    inp["loop_x"], inp["loop_y"] = _loop_data()
    inp["loop_L0"] = np.asarray(jax_dml.init_params(
        jloop.train.dml, jax.random.PRNGKey(jloop.train.ps.seed)))
    inp["loop_cfg"] = closed_loop_config_from_jax(jloop)
    return inp


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(every rank's results, the reference's): the JAX subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("multirank_moe")
    inp_path, out_path = tmp / "inputs.pkl", tmp / "reference.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump({k: v for k, v in inputs.items() if k != "loop_cfg"}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(inp_path), str(out_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        t0 = time.perf_counter()
        out = mesh_lib.spawn(ranks.run_all, N, device="cpu",
                             args=(inputs,), timeout=120.0)
        assert time.perf_counter() - t0 < 120.0
    finally:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    with open(out_path, "rb") as f:      # bytes this test's subprocess wrote
        return out, pickle.load(f)


def test_ranks_import_no_jax_and_nothing_of_repro(runs):
    out, _ = runs
    assert [r["rank"] for r in out] == list(range(N))
    assert all(r["foreign"] == [] for r in out)


# -- the collectives' gradients -----------------------------------------------

def test_collective_gradients_against_hand_values(runs):
    out, _ = runs
    c = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    g = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    for r, res in enumerate(o["collectives"] for o in out):
        assert torch.equal(res["psum"], c)
        assert torch.equal(res["pmean"], c / N)
        z, grad = res["gather"]
        assert torch.equal(z, torch.stack([torch.full((2, 3), s + 1.0)
                                           for s in range(N)]))
        w = torch.arange(24, dtype=torch.float32).reshape(N, 2, 3)
        assert torch.equal(grad, 10.0 * w[r])     # sum of (s + 1) over s
        z, grad = res["gather_tiled"]
        assert torch.equal(z, torch.cat([torch.full((2, 3), s + 1.0)
                                         for s in range(N)], dim=1))
        w = torch.arange(24, dtype=torch.float32).reshape(2, 12)
        assert torch.equal(grad, 10.0 * w[:, 3 * r:3 * r + 3])
        m = res["map"]
        assert torch.equal(m["gathered"], 3.0 * g)
        assert float(m["total"]) == float((g * g).sum() + 10.0 * g.sum())
        assert torch.equal(m["grad_a"], 2.0 * g + 3.0 * c.repeat(2, 2))
        assert torch.equal(m["grad_b"], torch.full((4, 6), 10.0))


# -- the moe layer ------------------------------------------------------------

@pytest.mark.parametrize("shape", list(ranks.SHAPES))
def test_moe_layer_matches_reference(runs, shape):
    out, ref = runs
    want = ref["layer"][shape]
    for r in out:
        got = r["layer"][shape]
        _close(got["y"], want["y"])
        assert abs(got["aux"] - want["aux"]) <= 1e-6
        assert torch.equal(got["y"], out[0]["layer"][shape]["y"])


@pytest.mark.parametrize("shape", list(ranks.SHAPES))
def test_moe_layer_gradients_match_reference(runs, shape):
    out, ref = runs
    want = ref["layer"][shape]
    for r in out:
        got = r["layer"][shape]
        assert set(got["grads"]) == set(want["grads"]) == \
            {"router", "w_gate", "w_up", "w_down"}
        for k in want["grads"]:
            _grad_close(got["grads"][k], want["grads"][k])
        _grad_close(got["grad_x"], want["grad_x"])


def test_live_mesh_without_expert_axis_is_one_device(runs):
    out, _ = runs
    assert all(r["layer"]["no_expert_axis"]["equal"] for r in out)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("shape", list(ranks.SHAPES))
def test_model_apply_matches_reference(runs, shape):
    out, ref = runs
    want = ref["apply"][shape]
    for r in out:
        got = r["model"]["apply"][shape]
        _close(got["logits"], want["logits"])
        assert abs(got["moe_aux"] - want["moe_aux"]) <= 1e-6


@pytest.mark.parametrize("shape", ranks.DECODE_SHAPES)
def test_decode_matches_reference_one_device(runs, shape):
    out, ref = runs
    for r in out:
        _close(r["model"]["decode"][shape], ref["decode"])


@pytest.fixture(scope="module")
def oracle(inputs):
    """The one-device oracle of the (2, 2) step: the mean over the two
    batch halves of the step's loss, each half through the one-process
    model; (loss, ce, moe_aux, grads, global norm)."""
    model = ranks.model_from(inputs)
    tok, lab = (torch.from_numpy(inputs[k]) for k in ("tokens", "labels"))
    halves = [{"tokens": tok[:B // 2], "labels": lab[:B // 2]},
              {"tokens": tok[B // 2:], "labels": lab[B // 2:]}]

    def loss(params, _):
        parts = [ranks.train_loss(model, params, h, None) for h in halves]
        return (sum(p[0] for p in parts) / 2,
                {k: sum(p[1][k] for p in parts) / 2
                 for k in ("ce", "moe_aux")})

    (value, aux), grads = value_and_grad(loss, model.param_tree(), None)
    norm = float(torch.sqrt(sum(torch.sum(g * g)
                                for g in tree_leaves(grads))))
    return float(value), aux, grads, norm


def test_train_step_matches_one_device_oracle(runs, oracle):
    out, _ = runs
    value, aux, grads, norm = oracle
    want = tree_leaves(grads)
    for r in out:
        tr = r["train"]
        np.testing.assert_allclose(tr["loss"], value, rtol=1e-5)
        np.testing.assert_allclose(tr["ce"], float(aux["ce"]), rtol=1e-5)
        np.testing.assert_allclose(tr["moe_aux"], float(aux["moe_aux"]),
                                   rtol=1e-5)
        assert tr["metrics"]["loss"] == tr["loss"]
        np.testing.assert_allclose(tr["metrics"]["grad_norm"], norm,
                                   rtol=1e-5)
        got = tree_leaves(tr["grads"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _grad_close(a, b)


def test_params_bit_identical_across_ranks_after_a_step(runs, inputs):
    out, _ = runs
    first = tree_leaves(out[0]["train"]["params"])
    for r in out[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(r["train"]["params"]), first))
    start = tree_leaves(ranks.model_from(inputs).param_tree())
    assert all(not torch.equal(a, b) for a, b in zip(first, start))


def test_state_shardings_are_named_on_a_live_mesh(runs):
    out, _ = runs
    assert all(r["train"]["named_specs"] and r["ps_specs"] for r in out)


# -- checkpoints and the pod meshes -------------------------------------------

def test_restore_checkpoint_shardings_match_reference(runs, inputs):
    out, ref = runs
    assert ref["restore_step"] == 7
    full = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                inputs["ckpt_shapes"],
                is_leaf=lambda s: isinstance(s, tuple))[0]}
    for rank, r in enumerate(out):
        assert r["restore"]["step"] == 7
        got = {jax.tree_util.keystr(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(
                   r["restore"]["params"], is_leaf=torch.is_tensor)[0]}
        want = ref["restore"][rank]
        assert set(got) == set(want) == set(full)
        for k, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(), want[k])
        # blocks, not copies of the whole leaf
        assert sum(tuple(leaf.shape) != full[k] for k, leaf in got.items()) \
            > len(got) // 2


@pytest.mark.parametrize("world", [4, 256, 512])
def test_production_mesh_rule(world):
    for multi_pod, size in ((False, 256), (True, 512)):
        if world == size:
            mesh = train.production_mesh(world, multi_pod)
            assert mesh == mesh_lib.make_production_mesh(multi_pod=multi_pod)
            assert mesh.size == world
        else:
            with pytest.raises(ValueError, match=f"{size} ranks"):
                train.production_mesh(world, multi_pod)


# -- the closed loop over a worker mesh ---------------------------------------

def test_closed_loop_over_ranks_matches_reference(runs):
    out, ref = runs
    r0 = out[0]["loop"]
    assert r0["lead"] and not any(r["loop"]["lead"] for r in out[1:])
    jt = SimpleNamespace(source=SimpleNamespace(_pool=ref["loop"]["pool"]))
    pt = SimpleNamespace(source=SimpleNamespace(_pool=r0["pool"]))
    _assert_same_runs(jt, ref["loop"]["hist"], ref["loop"]["L"], pt,
                      r0["hist"], r0["L"])
    assert r0["n_refreshes"] == 3
    assert all({"mine", "broadcast"} <= set(t) for t in r0["timings"])


def test_closed_loop_ranks_agree(runs):
    out, _ = runs
    r0 = out[0]["loop"]
    for r in out[1:]:
        loop = r["loop"]
        assert torch.equal(loop["L"], r0["L"])
        assert loop["hist"]["refreshes"] == r0["hist"]["refreshes"]
        assert loop["hist"]["steps"] == r0["hist"]["steps"]
        assert loop["hist"]["summary"] == r0["hist"]["summary"]
        for k in ("a", "b", "sim"):
            np.testing.assert_array_equal(loop["pool"][k], r0["pool"][k])
        assert all(t == ["broadcast"] for t in loop["timings"])


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
