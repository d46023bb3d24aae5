"""The dry run's per-rank program: one rank of a production mesh traced
in a fake world (``launch/mesh.fake_world``), and the same program run
for real on 4 gloo ranks on the CPU, held against the JAX reference and
the port's one-process oracle.

In the fake world (meta tensors, nothing allocated):

  * the reference's five dry-run invariants
    (``tests/test_dryrun_integration.py``) on the port's
    ``smollm-135m|train_4k`` record on 16x16, at the H100's rates, and
    its arguments equal to the sharding plan's;
  * the collectives of one dense layer at small width, counted by hand
    (kind, count, output bytes) on fake (2, 2) and (2, 2, 2) meshes:
    training, prefill, and decode with the cache over kv heads and over
    its sequence;
  * 256 x the per-rank FLOPs of gemma-7b training (cut to 2 layers; every
    dimension of gemma divides 16) within 1.00-1.10 of the one-card
    record's;
  * the paper's DML records on both meshes: imnet63k's 10,000 rows of L
    split over model, mnist's 600 and imnet1m's 1,000 replicated;
  * the fake world's own rules.

One module-scoped ``launch/mesh.spawn`` of 4 ranks runs every live case
(``tests/_dryrun_ranks.py``, which imports no jax), while a JAX
subprocess on 4 forced host devices (this file run as a script) computes
the reference's answers from the same numpy inputs:

  * ``psum_scatter`` and the repaired ``all_gather`` against hand values,
    forward and backward;
  * ``Model.apply(mesh=)`` (the per-rank prefill) against the reference's
    jitted ``Model.apply(params, batch, mesh=)`` on the same (data, model)
    mesh, for three dense patterns at reduced width: heads and kv heads
    over model; one kv head on two model ranks (GQA with replicated kv);
    9 heads on two (context parallelism, at T 2,560, past the chunked
    threshold);
  * one ``make_train_step(mesh=)`` AdamW step on (2, 2) and the decode
    (6 steps; the cache over kv heads, and over its sequence for the
    other two) against the port's one-process step (on rank 0) and
    decode and the reference's one-device ones (the reference's gradient
    and decode with a mesh fail under jax 0.9.0);
  * the per-rank Eq. 4 step, L's rows split over model and replicated,
    against the one-process step;
  * the collectives rank 0's training step issues, counted by
    ``CostMode`` on the live ranks, equal to the fake world's account of
    the same step.

Tolerances. The same f32 forms in another summation order: logits within
rtol 1e-5, atol 1e-5 x max |ref|; the loss and gradient norm within rtol
1e-5; each AdamW first moment (0.1 x the clipped gradient) within
GRAD_REL = 1e-4 of the leaf's largest |ref|. After AdamW's first step a
parameter moves by lr g / (|g| + eps), about lr times the sign of its
gradient, so where a gradient is near zero the two sides may step apart:
the parameters within 2 lr + 1e-6 everywhere and within 1e-6 on all but
1e-3 of them. The DML step's L within rtol 1e-5, atol 1e-6 x max |L|,
its loss within rtol 1e-6.
"""

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

import _dryrun_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = ranks.N_RANKS
GRAD_REL = 1e-4


# -- the record on the production mesh ---------------------------------------

@pytest.fixture(scope="module")
def record():
    return dryrun.dryrun_one("smollm-135m", "train_4k", "16x16")


def test_compiles_on_production_mesh(record):
    assert record["status"] == "ok"
    assert record["n_chips"] == 256
    assert record["mesh"] == {"data": 16, "model": 16}
    assert record["rank"] == 0


def test_fits_hbm(record):
    assert record["memory"]["temp_size"] < 16 * 2**30
    assert record["memory"]["argument_size"] < 16 * 2**30


def test_loop_corrected_flops_sane(record):
    """The rank's product FLOPs cover at least its share of 6ND and stay
    within two orders of it (the reference's bound)."""
    model_flops_per_chip = 6 * 110e6 * 256 * 4096 / 256
    flops = record["flops_per_chip"]
    assert flops > 0.8 * model_flops_per_chip, (flops, model_flops_per_chip)
    assert flops < 100 * model_flops_per_chip


def test_collectives_present_and_loop_multiplied(record):
    c = record["collectives"]
    assert c["total_bytes"] > 0
    # FSDP all-gathers fire once per layer per pass: far more than a handful
    assert sum(c["counts"].values()) > 50
    assert set(c["counts"]) <= set(dryrun.cost_analysis.COLLECTIVE_KINDS)
    assert c["total_bytes"] == sum(c["bytes"].values()) == \
        sum(c["by_link"].values())


def test_roofline_terms_consistent(record):
    """The reference's terms at the H100's rates: each dtype's FLOPs at
    its rate, HBM3, and each collective at its link (a model group of 16
    spans two nodes of 8, a data group 16)."""
    t = record["roofline"]
    assert t["compute_s"] == pytest.approx(sum(
        f / mesh_lib.PEAK_FLOPS_BY_DTYPE[d]
        for d, f in record["flops_by_dtype"].items()), rel=1e-6)
    assert t["memory_s"] == pytest.approx(
        record["hbm_bytes_per_chip"] / mesh_lib.HBM_BW, rel=1e-6)
    by_link = record["collectives"]["by_link"]
    assert set(by_link) == {"ib"}
    assert t["collective_s"] == pytest.approx(
        by_link["ib"] / mesh_lib.IB_BW, rel=1e-6)
    assert t["dominant"] in ("compute", "memory", "collective")


def test_record_arguments_are_the_plans(record):
    assert record["memory"]["argument_size"] == \
        record["plan"]["argument_size"]
    m = record["memory"]
    assert record["peak_bytes"] == m["argument_size"] + m["temp_size"]


# -- collectives of one dense layer, counted by hand -------------------------

FAKE = {"2x2": mesh_lib.Mesh(("data", "model"), (2, 2)),
        "2x2x2": mesh_lib.Mesh(("pod", "data", "model"), (2, 2, 2))}
HB, HT = 8, 16              # the hand-counted batch and sequence


def _hand_cfg(kv):
    """One dense layer: d 64, 4 heads of 16, ``kv`` kv heads, ffn 128,
    vocab 512, tied embeddings, bf16 activations, f32 weights."""
    return get_config("smollm-135m-reduced").replace(
        n_layers=1, d_model=64, d_ff=128, n_kv_heads=kv)


def _expected(mode, mesh, kv):
    """(count, bytes) by kind on one rank of ``mesh`` (data 2, model 2;
    pod 2 too): the program's collectives in the order it issues them."""
    cfg = _hand_cfg(kv)
    d, H, dh, F, V = cfg.d_model, cfg.n_heads, 16, cfg.d_ff, cfg.vocab_size
    nb = 4 if "pod" in mesh.shape else 2            # batch ranks
    Bl = HB // nb
    a = Bl * HT * d * 2                             # (B, T, d) bf16
    a_sp = a // 2                                   # its rows on a rank
    # weights all-gathered over data 2 (f32): the rank's model block
    tok = V // 2 * d * 4
    kvh = kv // 2 if kv % 2 == 0 else kv            # replicated if odd
    attn = [d * H // 2 * dh * 4, d * kvh * dh * 4, d * kvh * dh * 4,
            H // 2 * dh * d * 4]                    # wq wk wv wo
    mlp = [d * F // 2 * 4] * 3                      # w_gate w_up w_down
    out = {}

    def add(kind, *sizes):
        c, b = out.get(kind, (0, 0))
        out[kind] = (c + len(sizes), b + sum(sizes))

    if mode == "prefill":
        # embedding (tok gathered, the rows reduce-scattered into the
        # sequence-parallel residual), the block (the whole sequence
        # gathered before attention and before the MLP, each sublayer's
        # partial reduce-scattered), the logits (the rows gathered, tok)
        add("all-gather", tok, a, *attn, a, *mlp, a, tok)
        add("reduce-scatter", a_sp, a_sp, a_sp)
    elif mode == "train":
        add("all-gather", tok, a, *attn, a, *mlp, a, tok)   # forward
        add("reduce-scatter", a_sp, a_sp, a_sp)
        # the layer recomputed in backward (remat), up to its last
        # reduce-scatter, which checkpointing's early stop skips
        add("all-gather", a, *attn, a, *mlp)
        add("reduce-scatter", a_sp)
        # backward: each gather's is a reduce-scatter of the rank's slot,
        # each reduce-scatter's an all-gather
        add("reduce-scatter", tok // 2, a_sp, *(w // 2 for w in attn),
            a_sp, *(w // 2 for w in mlp), a_sp, tok // 2)
        add("all-gather", a, a, a)
        # the loss: 8 chunks of 2 tokens, each its max and (sum of exp,
        # label logit) over model, forward and recomputed; the loss over
        # the batch axes
        per_chunk = [Bl * 2 * 4, 2 * Bl * 2 * 4]
        add("all-reduce", *(per_chunk * 16), 4)
        # the gradients: the norm scales over every axis, the other
        # leaves over pod (their specs cover data and model); the clip's
        # squared norm
        add("all-reduce", 3 * d * 4)
        if "pod" in mesh.shape:
            add("all-reduce", sum([tok // 2] + [w // 2 for w in attn + mlp]))
        add("all-reduce", 4)
    elif kv == 2:                   # decode, the cache over kv heads
        add("all-gather", tok, *attn, *mlp, tok)
        add("all-reduce", Bl * d * 2, Bl * d * 2, Bl * d * 2)
    else:                           # decode, the cache over its sequence
        add("all-gather", tok, *attn, Bl * H * dh * 2, *mlp, tok)
        add("all-reduce", Bl * d * 2, Bl * H * 4,
            Bl * H * 4 + Bl * H * dh * 4, Bl * d * 2, Bl * d * 2)
    return out


@pytest.mark.parametrize("mesh_name", list(FAKE))
@pytest.mark.parametrize("mode,kv", [("train", 2), ("prefill", 2),
                                     ("decode", 2), ("decode", 1)])
def test_hand_counted_collectives(mode, kv, mesh_name):
    mesh = FAKE[mesh_name]
    with mesh_lib.fake_world(mesh) as live:
        rec = dryrun.rank_account(_hand_cfg(kv),
                                  InputShape("hand", HT, HB, mode), live)
    c = rec["collectives"]
    got = {k: (c["counts"][k], c["bytes"][k]) for k in c["counts"]}
    assert got == _expected(mode, mesh, kv)
    assert c["by_link"] == {"nvlink": c["total_bytes"]}


def test_per_rank_flops_match_the_one_card_record():
    """Every dimension of gemma-7b divides 16: 256 ranks do the one
    card's products, within 1.00-1.10 (cut to 2 layers)."""
    cut = {"n_layers": 2}
    rank = dryrun.dryrun_one("gemma-7b", "train_4k", "16x16", overrides=cut)
    one = dryrun.dryrun_one("gemma-7b", "train_4k", overrides=cut)
    ratio = 256 * rank["flops_per_chip"] / one["flops_per_chip"]
    assert 1.0 <= ratio <= 1.10, ratio


@pytest.mark.parametrize("mesh_name", ["16x16", "pod2x16x16"])
def test_dml_records(mesh_name):
    recs = dryrun.dryrun_dml(mesh_name)
    assert sorted(recs) == ["dml-imnet1m", "dml-imnet63k", "dml-mnist"]
    nb = 16 if mesh_name == "16x16" else 32
    for name, rec in recs.items():
        B, d, k = {"dml-mnist": (1000, 780, 600),
                   "dml-imnet63k": (100, 21504, 10000),
                   "dml-imnet1m": (1000, 21504, 1000)}[name]
        split = name == "dml-imnet63k"
        assert rec["status"] == "ok" and rec["rows_split"] == split
        assert rec["global_pair_batch"] == B * nb
        k_l = k // 16 if split else k
        assert rec["flops_by_dtype"] == {"float32": 4.0 * B * d * k_l}
        # d2 over model when L is split; the loss and dL over the pairs
        assert rec["collectives"]["counts"] == \
            {"all-reduce": 2 if split else 1}
        assert rec["memory"]["argument_size"] == \
            rec["plan"]["argument_size"] == \
            4 * k_l * d + 2 * 4 * B * d + 4 * B


def test_fake_world_rules():
    with mesh_lib.fake_world("16x16") as live:
        assert live.shape == {"data": 16, "model": 16}
        assert live.device == torch.device("meta") and live.rank == 0
        with pytest.raises(RuntimeError, match="live"):
            with mesh_lib.fake_world("16x16"):
                pass
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="spawn or join"):
        mesh_lib.rank_device()


def test_other_families_keep_the_plan_and_name_8f():
    """Every family now has its per-rank program: the
    hybrid family's decode on the pod mesh is rank 0's program, its
    arguments (the stacked cache under the plan's specs) the plan's, and
    its line reads as the account's."""
    rec = dryrun.dryrun_one("zamba2-2.7b", "decode_32k", "pod2x16x16",
                            overrides={"n_layers": 6})
    assert rec["status"] == "ok" and "pending" not in rec
    assert rec["memory"]["argument_size"] == rec["plan"]["argument_size"]
    line = dryrun.summary_line("zamba2-2.7b|decode_32k", rec)
    assert "collectives [" in line and "8f" not in line


# -- the reference: 4 forced host devices, in a subprocess --------------------

def _jcfg(case):
    return jax_reduced(jax_get_config(ranks.ARCH)).replace(
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
        tokens = jnp.asarray(inp["tokens"][case])
        out["prefill"][case] = {}
        for name in ranks.PREFILL_MESHES[case]:
            # the legacy mesh context: the reference's constrain reads it
            mesh = jax.make_mesh(ranks.SHAPES[name], ("data", "model"),
                                 axis_types=auto)
            with mesh:
                logits = jax.jit(lambda p, t, mesh=mesh: model.apply(
                    p, {"tokens": t}, mesh=mesh)[0])(params, tokens)
            out["prefill"][case][name] = np.asarray(logits)
        run = JaxRunConfig(arch=ranks.ARCH, lr=ranks.LR, total_steps=10,
                           warmup=0)
        opt = jax_steps.make_optimizer(run)
        state = jax_steps.TrainState(params, opt.init(params),
                                     jnp.zeros((), jnp.int32))
        new, metrics = jax.jit(jax_steps.make_train_step(model, opt, run))(
            state, {"tokens": tokens,
                    "labels": jnp.asarray(inp["labels"][case])})
        out["train"][case] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": jax.tree.map(np.asarray, new.params)}
        cache = model.init_decode_cache(ranks.BATCH[case], ranks.DECODE_LEN)
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
    inp = {"params": {}, "tokens": {}, "labels": {}, "dml": {}}
    for case in ranks.CASES:
        jcfg = _jcfg(case)
        inp["params"][case] = jax.tree.map(
            np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        shape = (ranks.BATCH[case], ranks.SEQ[case])
        inp["tokens"][case] = rng.randint(0, jcfg.vocab_size, shape) \
            .astype(np.int32)
        inp["labels"][case] = rng.randint(0, jcfg.vocab_size, shape) \
            .astype(np.int32)
    for name, dcfg in ranks.DML.items():
        B = ranks.DML_PAIRS * 2                     # pairs over data 2
        inp["dml"][name] = {
            "L": rng.randn(dcfg.proj_dim, dcfg.feat_dim).astype(np.float32)
            * 0.3,
            "batch": {"xs": rng.randn(B, dcfg.feat_dim).astype(np.float32),
                      "ys": rng.randn(B, dcfg.feat_dim).astype(np.float32),
                      "sim": (rng.rand(B) < 0.5).astype(np.int32)}}
    return inp


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(every rank's results, the reference's): the JAX subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("dryrun_ranks")
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
    with open(out_path, "rb") as f:      # bytes this test's subprocess wrote
        return out, pickle.load(f)


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=rel * float(np.abs(b).max()))


def _stepped_close(a, b):
    """Parameters after one AdamW step (the module docstring's rule)."""
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float(d.max()) <= 2 * ranks.LR + 1e-6
    assert float(np.mean(d > 1e-6)) <= 1e-3


def _leaves(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


def _stacked(tree):
    """The reference's stacked layout of a port tree (numpy leaves)."""
    from repro_torch.models.transformer import stack_blocks
    return jax.tree.map(np.asarray, stack_blocks(tree),
                        is_leaf=torch.is_tensor)


def test_ranks_import_no_jax_and_nothing_of_repro(runs):
    out, _ = runs
    assert [r["rank"] for r in out] == list(range(N))
    assert all(r["foreign"] == [] for r in out)


def test_psum_scatter_and_all_gather_against_hand_values(runs):
    out, _ = runs
    A = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    for r, res in enumerate(o["collectives"] for o in out):
        d, m = divmod(r, 2)
        y, gx = res["psum_scatter"]
        # the sum over the model pair (ranks 2d, 2d+1), this rank's rows
        assert torch.equal(y, (4 * d + 3) * A[2 * m:2 * m + 2])
        # backward: the pair's cotangents gathered
        assert torch.equal(gx, torch.cat([torch.full((2, 2), 2.0 * d + 1),
                                          torch.full((2, 2), 2.0 * d + 2)]))
        z, gz = res["gather"]
        assert torch.equal(z, torch.cat([torch.full((2, 3), s + 1.0)
                                         for s in range(N)], dim=1))
        assert torch.equal(gz, torch.full((2, 3), 10.0))


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_prefill_matches_reference_on_the_mesh(runs, case):
    out, ref = runs
    for name in ranks.PREFILL_MESHES[case]:
        want = ref["prefill"][case][name]
        for r in out:
            got = r["prefill"][case][name]
            _close(got, want)
            assert torch.equal(got, out[0]["prefill"][case][name])


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_train_step_matches_oracle_and_reference(runs, case):
    out, ref = runs
    want, one = ref["train"][case], out[0]["train"][case]
    for r in out:
        got = r["train"][case]
        for k in ("loss", "grad_norm"):
            for other in (one["one_metrics"][k], want["metrics"][k]):
                assert got["metrics"][k] == pytest.approx(other, rel=1e-5)
        for a, b in zip(_leaves(got["m"]), _leaves(one["one_m"])):
            assert float(np.abs(a - b).max()) <= \
                GRAD_REL * float(np.abs(b).max()) + 1e-12
        for a, b in zip(_leaves(got["params"]), _leaves(one["one_params"])):
            _stepped_close(a, b)
        stacked = _stacked(got["params"])
        for a, b in zip(jax.tree.leaves(stacked),
                        jax.tree.leaves(want["params"])):
            _stepped_close(a, b)
        for a, b in zip(_leaves(got["params"]),
                        _leaves(out[0]["train"][case]["params"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_decode_matches_oracle_and_reference(runs, case):
    out, ref = runs
    for r in out:
        got = r["decode"][case]
        _close(got["ranks"], got["one"])
        _close(got["ranks"], ref["decode"][case])


@pytest.mark.parametrize("name", list(ranks.DML))
def test_dml_rank_step_matches_one_process(runs, name):
    out, _ = runs
    for r in out:
        got = r["dml"][name]
        assert got["split"] == (name == "split")
        _close(got["L"], got["one_L"], rel=1e-6)
        assert got["loss"] == pytest.approx(got["one_loss"], rel=1e-6)


def test_live_collectives_equal_the_fake_worlds(runs):
    """Rank 0's training step on (2, 2), counted on the live ranks, and
    the fake world's account of the same step: equal by kind."""
    out, _ = runs
    cfg = ranks.config("dense")
    shape = InputShape("live", ranks.SEQ["dense"], ranks.BATCH["dense"],
                       "train")
    with mesh_lib.fake_world(FAKE["2x2"]) as live:
        rec = dryrun.rank_account(cfg, shape, live)
    want = rec["collectives"]
    got = out[0]["counted"]
    assert got["counts"] == want["counts"]
    assert got["bytes"] == want["bytes"]


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
