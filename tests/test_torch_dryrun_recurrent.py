"""The per-rank program of the recurrent families: the ssm family
(rwkv6: the time mix on the rank's heads, the channel mix column- then
row-parallel) and the hybrid family (zamba2: the mamba2 heads of the
rank, ``ssd_scan`` on them, and the shared attention block on its
heads). One rank of a production mesh traced in a fake world
(``launch/mesh.fake_world``), and the same program run for real on 4
gloo ranks on the CPU, held against the JAX reference and the port's
one-process oracle.

In the fake world (meta tensors, nothing allocated):

  * "ok" records of rwkv6-1.6b and zamba2-2.7b at every input shape on
    16x16 and pod2x16x16, cut to one layer (zamba2: one group of one
    mamba layer and the shared block), each with its arguments equal to
    the sharding plan's (the decode cache in the reference's stacked
    layout: rwkv6's wkv state over its key dim, its token shifts' layers
    over ``pod``, zamba2's conv history's batch over ``model``);
  * ``partition.reblock``'s collectives (the AdamW moments' and the
    caches' re-layout) on a fake (2, 2): a dimension moving from
    ``model`` to ``data`` is a gather and a cut, an axis moving between
    dimensions one all-to-all.

One module-scoped ``launch/mesh.spawn`` of 4 ranks runs every live case
(``tests/_dryrun_recurrent.py``, which imports no jax), while a JAX
subprocess on 4 forced host devices (this file run as a script)
computes the reference's answers from the same numpy inputs:

  * ``Model.apply(mesh=)`` (the per-rank prefill) on (2, 2) and (1, 4)
    against the reference's jitted ``Model.apply(params, batch, mesh=)``
    on the same (data, model) mesh (Auto axes, the legacy ``with
    mesh:``) and the port's one-process forward: rwkv6 at 16 heads of
    16 (4 and 8 a rank; its decay LoRA's columns cut to the rank's
    heads), zamba2 at 4 layers (two uses of the shared block; 2 and 1
    mamba heads of 128 a rank, the gated norm's sum over every head),
    both f32 (zamba2's SSD tiles too);
  * one ``make_train_step(mesh=)`` AdamW step on (2, 2) against the
    port's one-process step and gradient (on rank 0) and the reference's
    one-device step (its gradient with a mesh fails under jax 0.9.0);
  * the decode (4 steps at B 2, the cache stacked under the plan's specs
    inside ``decode_step(mesh=)``) against the port's one-process decode
    (logits and the last cache) and the reference's one-device one;
  * ``partition.reblock``'s moves, each rank's block against the one
    cut from the global tensor;
  * the collectives rank 0's zamba2 training step issues, counted by
    ``CostMode`` on the live ranks, equal to the fake world's account of
    the same step.

Tolerances, ``tests/test_torch_dryrun_ranks.py``'s: logits
within rtol 1e-5, atol 1e-5 x max |ref|; the loss and gradient norm
within rtol 1e-5; each AdamW first moment (0.1 x the clipped gradient)
within GRAD_REL = 1e-4 of the leaf's largest |ref|; the parameters
within 2 lr + 1e-6 everywhere and within 1e-6 on all but 1e-3 of them
(after AdamW's first step a parameter moves by about lr times the sign
of its gradient, so where a gradient is near zero the sides may step
apart); the caches as the logits.
"""

import multiprocessing
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import RunConfig as JaxRunConfig
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model

import _dryrun_recurrent as ranks
from repro_torch.configs import SHAPES
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import stack_cache
from repro_torch.sharding import partition
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = ranks.N_RANKS
GRAD_REL = 1e-4


# -- rank 0's records on the production meshes --------------------------------

RECORD_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
# zamba2 traced at SSD chunks of 1,024 and attention chunks of 8,192 (the
# chunked forms' loops 8 times shorter; no argument changes)
ONE_LAYER = {"rwkv6-1.6b": {"n_layers": 1},
             "zamba2-2.7b": {"n_layers": 1, "shared_attn_every": 1,
                             "ssm_chunk": 1024, "attn_q_chunk": 8192,
                             "attn_kv_chunk": 8192}}


RECORD_MESHES = ("16x16", "pod2x16x16")
RECORD_JOBS = 2             # processes, beside the ranks and the reference


def _start_records():
    """Every record of RECORD_ARCHS x SHAPES x RECORD_MESHES, traced in
    a pool of RECORD_JOBS processes (each in a fake world of its own);
    (pool, {(arch, shape, mesh): its result})."""
    pool = multiprocessing.get_context("spawn").Pool(RECORD_JOBS)
    jobs = {(a, s, m): pool.apply_async(dryrun._record, (
        dryrun.Job(a, s, ONE_LAYER[a]), m))
        for a in RECORD_ARCHS for s in SHAPES for m in RECORD_MESHES}
    pool.close()
    return pool, jobs


@pytest.mark.parametrize("mesh", RECORD_MESHES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", RECORD_ARCHS)
def test_records_are_ok_with_the_plans_arguments(runs, arch, shape, mesh):
    rec = runs[2][(arch, shape, mesh)]
    assert rec["status"] == "ok", rec
    assert rec["arch"] == arch and rec["shape"] == shape
    assert rec["rank"] == 0 and rec["n_chips"] == mesh_lib.MESHES[mesh].size
    assert rec["memory"]["argument_size"] == rec["plan"]["argument_size"]
    assert rec["collectives"]["total_bytes"] > 0
    if SHAPES[shape].mode == "decode":
        assert rec["plan"]["cache"] > 0


# -- reblock's collectives ----------------------------------------------------

def test_reblock_issues_one_all_to_all_where_an_axis_moves():
    """An axis moving between dimensions (the wkv state's ``model`` from
    its key dim to its heads; ``data`` from the rows to the columns of
    rwkv6's ``w_o`` moment) is one all-to-all; a dimension going from
    ``model`` to ``data`` is a gather and a cut (on meta, in a fake
    (2, 2))."""
    from repro_torch.launch.cost_analysis import CostMode
    fake = mesh_lib.Mesh(("data", "model"), (2, 2))
    with mesh_lib.fake_world(fake) as live:
        mode = CostMode()
        with mode:
            for (src, dst), shape in zip(ranks.REBLOCKS,
                                         ranks.REBLOCK_SHAPES):
                x = torch.empty(partition.local_shape(shape, src, fake),
                                device="meta")
                got = partition.reblock(x, src, dst, live)
                assert tuple(got.shape) == \
                    partition.local_shape(shape, dst, fake)
    c = mode.collectives()["counts"]
    assert c == {"all-gather": 2, "all-to-all": 2}


# -- the reference: 4 forced host devices, in a subprocess --------------------

def _jcfg(case):
    return jax_reduced(jax_get_config(ranks.ARCHS[case])).replace(
        dtype="float32", **ranks.CASES[case])


def _reference(inp_path, out_path):
    assert jax.device_count() == N, jax.device_count()
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    auto = (jax.sharding.AxisType.Auto,) * 2
    out = {"prefill": {}, "train": {}, "decode": {}}
    for case in ranks.CASES:
        model = jax_build_model(_jcfg(case))
        params = jax.tree.map(jnp.asarray, inp["params"][case])
        batch = {"tokens": jnp.asarray(inp["tokens"][case])}
        out["prefill"][case] = {}
        for name in ranks.PREFILL_MESHES:
            # the legacy mesh context: the reference's constrain reads it
            mesh = jax.make_mesh(ranks.SHAPES[name], ("data", "model"),
                                 axis_types=auto)
            with mesh:
                logits, _ = jax.jit(lambda p, b, mesh=mesh: model.apply(
                    p, b, mesh=mesh))(params, batch)
            out["prefill"][case][name] = np.asarray(logits)
        run = JaxRunConfig(arch=ranks.ARCHS[case], lr=ranks.LR,
                           total_steps=10, warmup=0)
        opt = jax_steps.make_optimizer(run)
        state = jax_steps.TrainState(params, opt.init(params),
                                     jnp.zeros((), jnp.int32))
        new, metrics = jax.jit(jax_steps.make_train_step(model, opt, run))(
            state, dict(batch, labels=jnp.asarray(inp["labels"][case])))
        out["train"][case] = {
            "metrics": {k: float(metrics[k]) for k in ("loss",
                                                       "grad_norm")},
            "params": jax.tree.map(np.asarray, new.params),
            "m": jax.tree.map(np.asarray, new.opt_state.m)}
        cache = model.init_decode_cache(ranks.DECODE_B, ranks.DECODE_LEN)
        tokens = jnp.asarray(inp["decode"][case])
        logits = []
        for t in range(ranks.DECODE_STEPS):
            lg, cache = model.decode_step(params, cache, tokens[:, t],
                                          jnp.int32(t))
            logits.append(np.asarray(lg))
        out["decode"][case] = np.stack(logits)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# -- inputs, the two runs -----------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    inp = {"params": {}, "tokens": {}, "labels": {}, "decode": {}}
    for case in ranks.CASES:
        jcfg = _jcfg(case)
        params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        # the constant leaves of the init (norm scales and biases, the
        # mixes, ln_scale, D, conv_b) given seeded noise, so that a
        # slice read at the wrong rank's heads shows
        leaves, tree = jax.tree.flatten(params)
        leaves = [np.asarray(x) for x in leaves]
        leaves = [x + 0.1 * rng.randn(*x.shape).astype(np.float32)
                  if x.ndim and np.all(x == x.reshape(-1)[0]) else x
                  for x in leaves]
        inp["params"][case] = jax.tree.unflatten(tree, leaves)
        shape = (ranks.BATCH, ranks.SEQ)
        inp["tokens"][case] = rng.randint(0, jcfg.vocab_size, shape) \
            .astype(np.int32)
        inp["labels"][case] = rng.randint(0, jcfg.vocab_size, shape) \
            .astype(np.int32)
        inp["decode"][case] = rng.randint(
            0, jcfg.vocab_size, (ranks.DECODE_B, ranks.DECODE_STEPS)) \
            .astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(every rank's results, the reference's, the records by (arch,
    shape, mesh)): the JAX subprocess and the records' pool run while
    the ranks do."""
    pool, jobs = _start_records()
    tmp = tmp_path_factory.mktemp("dryrun_recurrent")
    inp_path, out_path = tmp / "inputs.pkl", tmp / "reference.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inputs, f)
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
        out = mesh_lib.spawn(ranks.run_all, N, device="cpu",
                             args=(inputs,), timeout=300.0)
    finally:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    records = {k: job.get(timeout=600)[1] for k, job in jobs.items()}
    pool.join()
    with open(out_path, "rb") as f:      # bytes this test's subprocess wrote
        return out, pickle.load(f), records


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=rel * float(np.abs(b).max()))


def _grad_close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert float(np.abs(a - b).max()) <= \
        GRAD_REL * float(np.abs(b).max()) + 1e-12


def _stepped_close(got, want):
    """Parameter trees' leaves after one AdamW step (the module
    docstring's rule, the share counted over the whole tree)."""
    apart = total = 0
    for a, b in zip(got, want, strict=True):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert float(d.max()) <= 2 * ranks.LR + 1e-6
        apart += int((d > 1e-6).sum())
        total += d.size
    assert apart <= 1e-3 * total


def _leaves(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


def _stacked(tree):
    """The reference's stacked layout of a port tree (numpy leaves)."""
    from repro_torch.models.transformer import stack_blocks
    return jax.tree.map(np.asarray, stack_blocks(tree),
                        is_leaf=torch.is_tensor)


def _clipped(grads, max_norm=1.0):
    g = [np.asarray(x, np.float64) for x in tree_leaves(grads)]
    norm = float(np.sqrt(sum(np.sum(x * x) for x in g)))
    return [x * min(1.0, max_norm / (norm + 1e-12)) for x in g], norm


def test_ranks_import_no_jax_and_nothing_of_repro(runs):
    out = runs[0]
    assert [r["rank"] for r in out] == list(range(N))
    assert all(r["foreign"] == [] for r in out)


@pytest.mark.parametrize("mesh", ranks.PREFILL_MESHES)
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_prefill_matches_reference_on_the_mesh(runs, case, mesh):
    out, ref = runs[:2]
    want = ref["prefill"][case][mesh]
    for r in out:
        got = r["prefill"][case]
        _close(got[mesh], want)
        _close(got[mesh], got["one"])
        assert torch.equal(got[mesh], out[0]["prefill"][case][mesh])


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_train_step_matches_oracle_and_reference(runs, case):
    out, ref = runs[:2]
    want, one = ref["train"][case], out[0]["train"][case]
    clipped, one_norm = _clipped(one["one_grads"])
    for r in out:
        got = r["train"][case]
        for k in ("loss", "grad_norm"):
            assert got["metrics"][k] == pytest.approx(
                one["one"]["metrics"][k], rel=1e-5)
            assert got["metrics"][k] == pytest.approx(want["metrics"][k],
                                                      rel=1e-5)
        assert got["metrics"]["grad_norm"] == pytest.approx(one_norm,
                                                            rel=1e-5)
        # the first moment is 0.1 x the clipped gradient
        for a, g in zip(_leaves(got["m"]), clipped, strict=True):
            _grad_close(a, 0.1 * g)
        for a, b in zip(jax.tree.leaves(_stacked(got["m"])),
                        jax.tree.leaves(want["m"]), strict=True):
            _grad_close(a, b)
        _stepped_close(_leaves(got["params"]), _leaves(one["one"]["params"]))
        _stepped_close(jax.tree.leaves(_stacked(got["params"])),
                       jax.tree.leaves(want["params"]))
        for a, b in zip(_leaves(got["params"]), _leaves(one["params"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_decode_matches_oracle_and_reference(runs, case):
    out, ref = runs[:2]
    for r in out:
        got = r["decode"][case]
        _close(got["ranks"], got["one"])
        _close(got["ranks"], ref["decode"][case])
        for a, b in zip(tree_leaves(stack_cache(got["ranks_cache"])),
                        tree_leaves(stack_cache(got["one_cache"])),
                        strict=True):
            _close(a, b)


def test_reblock_gives_each_rank_its_block(runs):
    """``partition.reblock`` on the live ranks: each move gives every
    rank its block of the global tensor under the destination spec."""
    out = runs[0]
    data, model = ranks.SHAPES["2x2"]
    for r in out:
        for got, (src, dst), dims in zip(r["reblock"], ranks.REBLOCKS,
                                         ranks.REBLOCK_SHAPES):
            x = torch.arange(float(torch.Size(dims).numel())).reshape(dims)
            for dim, axis in enumerate(dst):
                if axis is not None:
                    n = dims[dim] // {"data": data, "model": model}[axis]
                    x = x.narrow(dim, r["coords"][axis] * n, n)
            assert torch.equal(got, x)


def test_live_collectives_equal_the_fake_worlds(runs):
    """Rank 0's zamba2 training step on (2, 2), counted on the live
    ranks, and the fake world's account of the same step: equal by
    kind."""
    out = runs[0]
    cfg = ranks.config("hybrid")
    shape = InputShape("live", ranks.SEQ, ranks.BATCH, "train")
    with mesh_lib.fake_world(mesh_lib.Mesh(("data", "model"), (2, 2))) \
            as live:
        rec = dryrun.rank_account(cfg, shape, live)
    want = rec["collectives"]
    got = out[0]["counted"]
    assert got["counts"] == want["counts"]
    assert got["bytes"] == want["bytes"]
    assert "all-reduce" in got["counts"]      # the gated norm's sums


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
