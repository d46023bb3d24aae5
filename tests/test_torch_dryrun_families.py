"""The per-rank program of the attention families other than dense: the
moe family (its expert map nested in the program), the vlm family
(pixtral: patch embeddings in) and the audio family (hubert: frame
embeddings in, non-causal attention, biases). One rank of a production
mesh traced in a fake world (``launch/mesh.fake_world``), and the same
program run for real on 4 gloo ranks on the CPU, held against the JAX
reference and the port's one-process oracle.

In the fake world (meta tensors, nothing allocated):

  * the reference's five dry-run invariants
    (``tests/test_dryrun_integration.py``) on one record a family on
    16x16, at reduced depth (granite-moe-1b, pixtral-12b and
    hubert-xlarge at ``train_4k``, 4 layers), each with its arguments
    equal to the sharding plan's;
  * the collectives of one moe layer at small width, counted by hand
    (kind, count, output bytes) on fake (2, 2) and (2, 2, 2) meshes:
    training, prefill and decode;
  * a decode (qwen3-moe) and two 32k prefills (pixtral, hubert) cut to
    one layer give "ok" records with the plan's arguments; hubert's
    decode stays skipped, and the rwkv6 and zamba2 records, once the
    plan alone, are "ok" too (``tests/test_torch_dryrun_recurrent.py``
    holds them at every shape).

One module-scoped ``launch/mesh.spawn`` of 4 ranks runs every live case
(``tests/_dryrun_families.py``, which imports no jax), while a JAX
subprocess on 4 forced host devices (this file run as a script)
computes the reference's answers from the same numpy inputs:

  * ``Model.apply(mesh=)`` (the per-rank prefill) against the reference's
    jitted ``Model.apply(params, batch, mesh=)`` on the same (data,
    model) mesh (Auto axes, the legacy ``with mesh:``): the reduced
    granite-moe on (2, 2) and (1, 4) (its 4 experts over model, the
    capacity per batch shard), pixtral from patch embeddings on (2, 2)
    (GQA 4/2), hubert from frame embeddings on (2, 2) and (1, 4) (a
    vocab of 510: split over model 2, whole on model 4); ``moe_aux``
    too;
  * one ``make_train_step(mesh=)`` AdamW step on (2, 2) (and hubert's
    on (1, 4), its vocab whole on every rank) against the
    port's one-process gradient (on rank 0) and the reference's
    one-device step: of the whole batch for pixtral and hubert; for the
    moe, whose capacity is taken per batch shard, of the mean over the
    two batch halves (the reference's own pieces: ``Model.hidden``,
    ``chunked_ce_loss``, ``clip_by_global_norm``, AdamW), since the
    reference's gradient with a mesh fails under jax 0.9.0;
  * the decode (4 steps at B 2, the moe and pixtral on tokens) against
    the port's one-process decode and the reference's one-device one;
  * the collectives rank 0's moe training step issues, counted by
    ``CostMode`` on the live ranks, equal to the fake world's account of
    the same step.

Tolerances, PR 32's (``tests/test_torch_dryrun_ranks.py``). The same f32
forms in another summation order: logits within rtol 1e-5, atol 1e-5 x
max |ref|; moe_aux within 1e-6; the loss and gradient norm within rtol
1e-5; each AdamW first moment (0.1 x the clipped gradient) within
GRAD_REL = 1e-4 of the leaf's largest |ref|. After AdamW's first step a
parameter moves by lr g / (|g| + eps), about lr times the sign of its
gradient, so where a gradient is near zero the two sides may step apart:
the parameters within 2 lr + 1e-6 everywhere and within 1e-6 on all but
1e-3 of them, counted over the whole tree: hubert's key bias has no
gradient (a query's softmax does not move when one vector is added to
every key), so each side steps it by the sign of its rounding noise.
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
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import clip_by_global_norm as jax_clip

import _dryrun_families as ranks
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = ranks.N_RANKS
GRAD_REL = 1e-4


# -- one record a family on the production mesh -------------------------------

RECORD_ARCHS = {"moe": "granite-moe-1b-a400m", "vlm": "pixtral-12b",
                "audio": "hubert-xlarge"}
RECORD_LAYERS = 4


@pytest.fixture(scope="module")
def records():
    return {fam: dryrun.dryrun_one(arch, "train_4k", "16x16",
                                   overrides={"n_layers": RECORD_LAYERS})
            for fam, arch in RECORD_ARCHS.items()}


@pytest.mark.parametrize("family", list(RECORD_ARCHS))
def test_compiles_on_production_mesh(records, family):
    rec = records[family]
    assert rec["status"] == "ok"
    assert rec["n_chips"] == 256
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["rank"] == 0


@pytest.mark.parametrize("family", list(RECORD_ARCHS))
def test_fits_hbm(records, family):
    m = records[family]["memory"]
    assert m["temp_size"] < 16 * 2**30
    assert m["argument_size"] < 16 * 2**30


@pytest.mark.parametrize("family", list(RECORD_ARCHS))
def test_loop_corrected_flops_sane(records, family):
    """The rank's FLOPs cover at least its share of 6ND (N the active
    parameters) and stay within two orders of it."""
    rec = records[family]
    share = rec["model_flops"] / 256
    assert 0.8 * share < rec["flops_per_chip"] < 100 * share


@pytest.mark.parametrize("family", list(RECORD_ARCHS))
def test_collectives_present_and_loop_multiplied(records, family):
    c = records[family]["collectives"]
    assert c["total_bytes"] > 0
    # FSDP all-gathers fire once per layer per pass
    assert sum(c["counts"].values()) > 50
    assert set(c["counts"]) <= set(dryrun.cost_analysis.COLLECTIVE_KINDS)
    assert c["total_bytes"] == sum(c["bytes"].values()) == \
        sum(c["by_link"].values())


@pytest.mark.parametrize("family", list(RECORD_ARCHS))
def test_roofline_terms_consistent(records, family):
    rec = records[family]
    t = rec["roofline"]
    assert t["compute_s"] == pytest.approx(sum(
        f / mesh_lib.PEAK_FLOPS_BY_DTYPE[d]
        for d, f in rec["flops_by_dtype"].items()), rel=1e-6)
    assert t["memory_s"] == pytest.approx(
        rec["hbm_bytes_per_chip"] / mesh_lib.HBM_BW, rel=1e-6)
    by_link = rec["collectives"]["by_link"]
    assert set(by_link) == {"ib"}
    assert t["collective_s"] == pytest.approx(
        by_link["ib"] / mesh_lib.IB_BW, rel=1e-6)
    assert t["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("family", list(RECORD_ARCHS))
def test_record_arguments_are_the_plans(records, family):
    rec = records[family]
    assert rec["memory"]["argument_size"] == rec["plan"]["argument_size"]
    m = rec["memory"]
    assert rec["peak_bytes"] == m["argument_size"] + m["temp_size"]


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen3-moe-30b-a3b", "decode_32k", "pod2x16x16"),
    ("pixtral-12b", "prefill_32k", "16x16"),
    ("hubert-xlarge", "prefill_32k", "pod2x16x16")])
def test_other_shapes_give_ok_records(arch, shape, mesh):
    """A decode (the moe nested in the decode program) and two 32k
    prefills (pixtral causal, hubert non-causal, context chunks), cut to
    one layer: "ok" records with the plan's arguments."""
    rec = dryrun.dryrun_one(arch, shape, mesh, overrides={"n_layers": 1})
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_size"] == rec["plan"]["argument_size"]


def test_hubert_decode_stays_skipped_and_the_recurrent_families_plan():
    """hubert's decode stays skipped; the rwkv6 and zamba2 records, once
    the plan alone, are rank 0's program with the plan's arguments (cut
    to one layer, one group)."""
    rec = dryrun.dryrun_one("hubert-xlarge", "decode_32k", "16x16")
    assert rec["status"] == "skipped"
    for arch, cut in (("rwkv6-1.6b", {"n_layers": 1}),
                      ("zamba2-2.7b", {"n_layers": 1,
                                       "shared_attn_every": 1})):
        rec = dryrun.dryrun_one(arch, "train_4k", "16x16", overrides=cut)
        assert rec["status"] == "ok" and "pending" not in rec
        assert rec["memory"]["argument_size"] == \
            rec["plan"]["argument_size"]


# -- collectives of one moe layer, counted by hand ----------------------------

FAKE = {"2x2": mesh_lib.Mesh(("data", "model"), (2, 2)),
        "2x2x2": mesh_lib.Mesh(("pod", "data", "model"), (2, 2, 2))}
HB, HT = 8, 16              # the hand-counted batch and sequence


def _hand_cfg():
    """One moe layer: d 64, 4 heads of 16 on 2 kv heads, 4 experts of
    ffn 128, top 2, vocab 512, tied embeddings, bf16 activations, f32
    weights."""
    return get_config("granite-moe-1b-a400m-reduced").replace(
        n_layers=1, d_model=64, d_ff=128)


def _expected(mode, mesh):
    """(count, bytes) by kind on one rank of ``mesh`` (data 2, model 2;
    pod 2 too): the program's collectives."""
    cfg = _hand_cfg()
    d, H, dh, F, V, E = (cfg.d_model, cfg.n_heads, 16, cfg.d_ff,
                         cfg.vocab_size, cfg.n_experts)
    nb = 4 if "pod" in mesh.shape else 2            # batch ranks
    Bl = HB // nb
    a = Bl * HT * d * 2                             # (B, T, d) bf16
    a_sp = a // 2                                   # its rows on a rank
    # weights all-gathered over data 2 (f32): the rank's model block
    tok = V // 2 * d * 4
    attn = [d * H // 2 * dh * 4, d * 1 * dh * 4, d * 1 * dh * 4,
            H // 2 * dh * d * 4]                    # wq wk wv wo
    # the router (replicated over model) and the rank's 2 experts
    moe = [d * E * 4] + [E // 2 * d * F * 4] * 3
    aux = 4                                         # the pmean of aux
    out = {}

    def add(kind, *sizes):
        c, b = out.get(kind, (0, 0))
        out[kind] = (c + len(sizes), b + sum(sizes))

    if mode == "prefill":
        # as the dense layer's, the moe's weights in the MLP's place and
        # aux pmeaned over model and the batch axes
        add("all-gather", tok, a, *attn, a, *moe, a, tok)
        add("reduce-scatter", a_sp, a_sp, a_sp)
        add("all-reduce", aux)
    elif mode == "train":
        add("all-gather", tok, a, *attn, a, *moe, a, tok)   # forward
        add("reduce-scatter", a_sp, a_sp, a_sp)
        add("all-reduce", aux)
        # the layer recomputed in backward (remat) up to the experts'
        # combine, the last tensor the backward saves: checkpointing's
        # early stop skips aux's pmean and the last reduce-scatter
        add("all-gather", a, *attn, a, *moe)
        add("reduce-scatter", a_sp)
        # backward: each gather's is a reduce-scatter of the rank's slot,
        # each reduce-scatter's an all-gather (psum's passes through)
        add("reduce-scatter", tok // 2, a_sp, *(w // 2 for w in attn),
            a_sp, *(w // 2 for w in moe), a_sp, tok // 2)
        add("all-gather", a, a, a)
        # the loss: 8 chunks of 2 tokens, each its max and (sum of exp,
        # label logit) over model, forward and recomputed; the loss over
        # the batch axes
        per_chunk = [Bl * 2 * 4, 2 * Bl * 2 * 4]
        add("all-reduce", *(per_chunk * 16), 4)
        # the gradients: the norm scales over every axis, the router over
        # model (and pod), the other leaves over pod; the clip's norm
        add("all-reduce", 3 * d * 4)
        if "pod" in mesh.shape:
            add("all-reduce", d * E // 2 * 4)
            add("all-reduce", sum([tok // 2] + [w // 2 for w in attn]
                                  + [w // 2 for w in moe[1:]]))
        else:
            add("all-reduce", d * E // 2 * 4)
        add("all-reduce", 4)
    else:                           # decode, the cache over kv heads
        add("all-gather", tok, *attn, *moe, tok)
        add("all-reduce", Bl * d * 2, Bl * d * 2, aux, Bl * d * 2)
    return out


@pytest.mark.parametrize("mesh_name", list(FAKE))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_hand_counted_moe_collectives(mode, mesh_name):
    mesh = FAKE[mesh_name]
    with mesh_lib.fake_world(mesh) as live:
        rec = dryrun.rank_account(_hand_cfg(),
                                  InputShape("hand", HT, HB, mode), live)
    c = rec["collectives"]
    got = {k: (c["counts"][k], c["bytes"][k]) for k in c["counts"]}
    assert got == _expected(mode, mesh)
    assert c["by_link"] == {"nvlink": c["total_bytes"]}


# -- the reference: 4 forced host devices, in a subprocess --------------------

def _jcfg(case):
    return jax_reduced(jax_get_config(ranks.ARCHS[case])).replace(
        dtype="float32", **ranks.CASES[case])


def _jbatch(inp, case, labels=True):
    key = "tokens" if case == "moe" else "embeddings"
    out = {key: jnp.asarray(inp[key][case])}
    if labels:
        out["labels"] = jnp.asarray(inp["labels"][case])
    return out


def _reference_step(model, opt, run, params, batch, halves):
    """The reference's step on one device: its own ``make_train_step``,
    or with ``halves`` the same step of the mean over the two batch
    halves of its loss."""
    state = jax_steps.TrainState(params, opt.init(params),
                                 jnp.zeros((), jnp.int32))
    if not halves:
        new, metrics = jax.jit(jax_steps.make_train_step(model, opt, run))(
            state, batch)
        return new, metrics
    cfg = model.cfg
    B = ranks.BATCH

    def loss_fn(params):
        total = 0.0
        for sl in (slice(0, B // 2), slice(B // 2, B)):
            b = {k: v[sl] for k, v in batch.items()}
            h, aux = model.hidden(params, b, remat=run.remat)
            ce = jax_steps.chunked_ce_loss(model, params, h, b["labels"])
            total = total + ce + cfg.moe_aux_weight * aux["moe_aux"]
        return total / 2

    @jax.jit
    def step(state):
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        grads, gnorm = jax_clip(grads, run.grad_clip)
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params)
        return (jax_steps.TrainState(jax_apply_updates(state.params,
                                                       updates),
                                     opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step(state)


def _reference(inp_path, out_path):
    assert jax.device_count() == N, jax.device_count()
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    auto = (jax.sharding.AxisType.Auto,) * 2
    out = {"prefill": {}, "train": {}, "decode": {}}
    for case in ranks.CASES:
        model = jax_build_model(_jcfg(case))
        params = jax.tree.map(jnp.asarray, inp["params"][case])
        batch = _jbatch(inp, case, labels=False)
        out["prefill"][case] = {}
        for name in ranks.PREFILL_MESHES[case]:
            # the legacy mesh context: the reference's constrain reads it
            mesh = jax.make_mesh(ranks.SHAPES[name], ("data", "model"),
                                 axis_types=auto)
            with mesh:
                logits, aux = jax.jit(lambda p, b, mesh=mesh: model.apply(
                    p, b, mesh=mesh))(params, batch)
            out["prefill"][case][name] = {
                "logits": np.asarray(logits),
                "moe_aux": float(aux["moe_aux"])}
        run = JaxRunConfig(arch=ranks.ARCHS[case], lr=ranks.LR,
                           total_steps=10, warmup=0)
        opt = jax_steps.make_optimizer(run)
        new, metrics = _reference_step(model, opt, run, params,
                                       _jbatch(inp, case), case == "moe")
        out["train"][case] = {
            "metrics": {k: float(metrics[k]) for k in ("loss",
                                                       "grad_norm")},
            "params": jax.tree.map(np.asarray, new.params),
            "m": jax.tree.map(np.asarray, new.opt_state.m)}
        if case in ranks.DECODES:
            cache = model.init_decode_cache(ranks.DECODE_B,
                                            ranks.DECODE_LEN)
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
    inp = {"params": {}, "tokens": {}, "embeddings": {}, "labels": {},
           "decode": {}}
    for case in ranks.CASES:
        jcfg = _jcfg(case)
        params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        # the constant leaves of the init (biases, norm scales) given
        # seeded noise, so that a bias added twice or a scale read at the
        # wrong block shows
        leaves, tree = jax.tree.flatten(params)
        leaves = [np.asarray(x) for x in leaves]
        leaves = [x + 0.1 * rng.randn(*x.shape).astype(np.float32)
                  if x.ndim and np.all(x == x.reshape(-1)[0]) else x
                  for x in leaves]
        inp["params"][case] = jax.tree.unflatten(tree, leaves)
        shape = (ranks.BATCH, ranks.SEQ)
        if case == "moe":
            inp["tokens"][case] = rng.randint(0, jcfg.vocab_size, shape) \
                .astype(np.int32)
        else:
            inp["embeddings"][case] = rng.randn(
                *shape, jcfg.d_model).astype(np.float32)
        inp["labels"][case] = rng.randint(0, jcfg.vocab_size, shape) \
            .astype(np.int32)
        if case in ranks.DECODES:
            inp["decode"][case] = rng.randint(
                0, jcfg.vocab_size, (ranks.DECODE_B, ranks.DECODE_STEPS)) \
                .astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(every rank's results, the reference's): the JAX subprocess runs
    while the ranks do."""
    tmp = tmp_path_factory.mktemp("dryrun_families")
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


def test_ranks_import_no_jax_and_nothing_of_repro(runs):
    out, _ = runs
    assert [r["rank"] for r in out] == list(range(N))
    assert all(r["foreign"] == [] for r in out)


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_prefill_matches_reference_on_the_mesh(runs, case):
    out, ref = runs
    for name in ranks.PREFILL_MESHES[case]:
        want = ref["prefill"][case][name]
        for r in out:
            got = r["prefill"][case][name]
            _close(got["logits"], want["logits"])
            assert abs(got["moe_aux"] - want["moe_aux"]) <= 1e-6
            assert torch.equal(got["logits"],
                               out[0]["prefill"][case][name]["logits"])


def test_moe_prefill_routes_and_has_aux(runs):
    """The moe's aux is its router's (non-zero), the other families'
    zero."""
    out, ref = runs
    for case in ranks.CASES:
        aux = ref["prefill"][case]["2x2"]["moe_aux"]
        assert (aux > 0) == (case == "moe")


def _clipped(grads, max_norm=1.0):
    g = [np.asarray(x, np.float64) for x in tree_leaves(grads)]
    norm = float(np.sqrt(sum(np.sum(x * x) for x in g)))
    return [x * min(1.0, max_norm / (norm + 1e-12)) for x in g], norm


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_train_step_matches_oracle_and_reference(runs, case):
    _check_train(runs, "train", case)


def test_train_step_with_the_vocab_whole_on_every_rank(runs):
    """hubert's step on (1, 4), where its vocab of 510 does not divide
    the model axis: every rank computes the whole cross-entropy, which
    must count once in the gradients."""
    _check_train(runs, "train_1x4", "audio")


def _check_train(runs, key, case):
    out, ref = runs
    want, one = ref["train"][case], out[0][key][case]
    clipped, one_norm = _clipped(one["one_grads"])
    for r in out:
        got = r[key][case]
        assert got["metrics"]["loss"] == pytest.approx(one["one_loss"],
                                                       rel=1e-5)
        assert got["metrics"]["grad_norm"] == pytest.approx(one_norm,
                                                            rel=1e-5)
        for k in ("loss", "grad_norm"):
            assert got["metrics"][k] == pytest.approx(want["metrics"][k],
                                                      rel=1e-5)
        # the first moment is 0.1 x the clipped gradient
        for a, g in zip(_leaves(got["m"]), clipped):
            _grad_close(a, 0.1 * g)
        for a, b in zip(jax.tree.leaves(_stacked(got["m"])),
                        jax.tree.leaves(want["m"])):
            _grad_close(a, b)
        _stepped_close(jax.tree.leaves(_stacked(got["params"])),
                       jax.tree.leaves(want["params"]))
        for a, b in zip(_leaves(got["params"]),
                        _leaves(out[0][key][case]["params"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ranks.DECODES)
def test_decode_matches_oracle_and_reference(runs, case):
    out, ref = runs
    for r in out:
        got = r["decode"][case]
        _close(got["ranks"], got["one"])
        _close(got["ranks"], ref["decode"][case])


def test_live_collectives_equal_the_fake_worlds(runs):
    """Rank 0's moe training step on (2, 2), counted on the live ranks,
    and the fake world's account of the same step: equal by kind."""
    out, _ = runs
    cfg = ranks.config("moe")
    shape = InputShape("live", ranks.SEQ, ranks.BATCH, "train")
    with mesh_lib.fake_world(FAKE["2x2"]) as live:
        rec = dryrun.rank_account(cfg, shape, live)
    want = rec["collectives"]
    got = out[0]["counted"]
    assert got["counts"] == want["counts"]
    assert got["bytes"] == want["bytes"]


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
