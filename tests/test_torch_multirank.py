"""The port over a live mesh of 4 gloo ranks on the CPU, held against the
JAX reference.

One module-scoped ``launch/mesh.spawn`` of 4 ranks runs every rank-side
case (``tests/_multirank_ranks.py``, which imports no jax): the mesh's
coordinates and sub-groups on (data 4, model 1) and (data 2, model 2);
``psum`` / ``pmean`` / ``all_gather`` / ``axis_index`` against hand
values; ``constrain`` / ``shard_map`` / ``shard_batch``; the PS over the
worker mesh under bsp, local (tau 2) and ssp (s 2) and one
``make_train_chunk`` call, held against the reference's P = 4 runs on 8
forced host devices (a subprocess, as test_torch_train.py's) within rtol
1e-4 and against the one-process port; bsp copies bit-identical across
ranks, local and ssp copies apart between syncs and equal on sync steps;
the sharded ``ExactIndex`` (k_top 1, 10 and 200 > the 150 rows of a
shard; duplicated rows for ties) and ``IVFIndex`` against the
reference's single-device answers (ids exact, distances to f32
rounding), a row count that does not divide the shards (replicated),
and an engine on rank 0 over each sharded index with the other ranks
following. Then ``serve_retrieval --data 4 --device cpu`` against
``--data 1``, a rank that raises, a collective past its timeout, and
``device=None`` without a card.

The one-process port sums the workers' gradients in another order than
the ranks' all-reduce, so the two part by f32 rounding: on this file's
runs at most 6.0e-8 on L after 20 steps (max |L| 0.12) and 4.8e-7 on a
loss; held within rtol 1e-5, atol 1e-6.

Run as a script (``python tests/test_torch_multirank.py OUT.npz``) it is
the reference's subprocess.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dml as jax_dml
from repro.core import losses as jax_losses
from repro.core.ps import sync as jax_sync
from repro.core.ps import trainer as jax_trainer
from repro.data import loader as jax_loader
from repro import optim as jax_optim
from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import IVFIndex as JaxIVFIndex

import _multirank_ranks as ranks
from repro_torch import optim
from repro_torch.core import dml
from repro_torch.core.ps import sync, trainer
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve_retrieval
from repro_torch.sharding import partition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = ranks.N_RANKS


# -- the reference: P = 4 on 8 forced host devices, in a subprocess ----------

def _reference_runs(out_path):
    """The subprocess: the reference's P = 4 runs (test_torch_train.py's
    recipe at tau 2 / staleness 2) and one chunk call."""
    assert jax.device_count() == 8, jax.device_count()
    train = ranks.dataset()
    dcfg = jax_dml.DMLConfig(feat_dim=ranks.FEAT, proj_dim=ranks.PROJ)
    out = {"L0": np.asarray(jax_dml.init_params(dcfg, jax.random.PRNGKey(0)))}
    for mode, kw in ranks.MODES.items():
        cfg = jax_trainer.DMLTrainConfig(
            dml=dcfg, ps=jax_sync.PSConfig(n_workers=N, **kw),
            batch_size=ranks.BATCH, steps=ranks.STEPS, lr=ranks.LR,
            log_every=1)
        L, hist = jax_trainer.train_dml_distributed(cfg, train)
        out[f"L_{mode}"] = np.asarray(L)
        out[f"loss_{mode}"] = np.array([h["loss"] for h in hist])
    # sync.py's SSP draw: fold_in(fold_in(PRNGKey(seed), step), worker)
    key = jax.random.PRNGKey(0)
    out["delays"] = np.array(
        [[int(jax.random.randint(jax.random.fold_in(
            jax.random.fold_in(key, t), w), (), 0,
            ranks.MODES["ssp"]["staleness"])) for w in range(N)]
         for t in range(ranks.STEPS)])
    ps = jax_sync.PSConfig(n_workers=N, sync="local", tau=ranks.CHUNK_TAU)
    opt = jax_optim.sgd(ranks.LR)
    chunk = jax_sync.make_train_chunk(
        lambda p, b: jax_losses.dml_pair_loss(p, b), opt, ps,
        jax_sync.make_worker_mesh(N))
    batches = jax_trainer._stacked_batches(
        jax_loader.partition_pairs(train, N), ranks.BATCH, seed=0)
    steps = [next(batches) for _ in range(ranks.CHUNK_TAU)]
    state, m = chunk(jax_sync.init_state(opt, jnp.asarray(out["L0"]), ps),
                     {k: jnp.stack([b[k] for b in steps], axis=1)
                      for k in steps[0]})
    out["L_chunk"] = np.asarray(state.params)
    out["loss_chunk"] = np.asarray(m["loss"])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("multirank") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         os.path.join(REPO, "tests")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return dict(np.load(out))


# -- the inputs and the reference's single-device serving answers ------------

def _exact_data(Nq=20, M=600, d=48, k=16, seed=0):
    rng = np.random.RandomState(seed)
    L = (0.3 * rng.randn(k, d)).astype(np.float32)
    q = rng.randn(Nq, d).astype(np.float32)
    G = rng.randn(M, d).astype(np.float32)
    G[300:340] = G[0:40]            # duplicated rows: exact distance ties
    G[455] = G[151]                 # a tie across shards
    q[3] = G[151]                   # ... at the top of one query's list
    return L, q, G


def _ivf_data(m=600, d=24, k=12, n_blobs=10, seed=0):
    """test_torch_ann.py's clustered gallery."""
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(n_blobs, d).astype(np.float32)
    blob = rng.randint(0, n_blobs, m)
    pts = centers[blob] + 0.3 * rng.randn(m, d).astype(np.float32)
    L = (rng.randn(k, d) / np.sqrt(d)).astype(np.float32)
    q = pts[rng.randint(0, m, 24)] + 0.1 * rng.randn(24, d).astype(np.float32)
    return L, pts.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def inputs(reference):
    L, q, G = _exact_data()
    jidx = JaxExactIndex.build(jnp.asarray(L), jnp.asarray(G))
    iL, iG, iq = _ivf_data()
    igp = np.asarray(iG @ iL.T, np.float32)
    ign = np.sum(igp * igp, axis=1).astype(np.float32)
    return {"L0": reference["L0"], "delays": reference["delays"],
            "L": L, "q": q, "G": G, "gp": np.asarray(jidx.gp),
            "gn": np.asarray(jidx.gn), "ivf_L": iL, "ivf_gp": igp,
            "ivf_gn": ign, "ivf_q": iq,
            "ivf_start": int(jax.random.randint(
                jax.random.PRNGKey(ranks.IVF_KW["seed"]), (), 0, len(igp)))}


@pytest.fixture(scope="module")
def jax_answers(inputs):
    """The reference's single-device answers on the same arrays."""
    jidx = JaxExactIndex.build(jnp.asarray(inputs["L"]),
                               jnp.asarray(inputs["G"]))
    q = jnp.asarray(inputs["q"])
    exact = {k: jidx.topk(q, k) for k in ranks.KS}
    jivf = JaxIVFIndex.build_projected(
        jnp.asarray(inputs["ivf_L"]), jnp.asarray(inputs["ivf_gp"]),
        jnp.asarray(inputs["ivf_gn"]), **ranks.IVF_KW)
    iq = jnp.asarray(inputs["ivf_q"])
    return {"exact": exact,
            "ivf": {n: jivf.topk(iq, 7, nprobe=n) for n in ranks.NPROBES},
            "ivf_cap": jivf.cap}


@pytest.fixture(scope="module")
def run(inputs):
    """Every rank's results from one spawn of 4 gloo ranks."""
    t0 = time.perf_counter()
    out = mesh_lib.spawn(ranks.run_all, N, device="cpu", args=(inputs,),
                         timeout=120.0)
    assert time.perf_counter() - t0 < 120.0
    return out


def _same_answers(ours, theirs):
    d, i = ours
    d_r, i_r = theirs
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_r))
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_r), rtol=1e-5,
                               atol=1e-4)


# -- the mesh and its collectives ---------------------------------------------

def test_ranks_import_no_jax_and_nothing_of_repro(run):
    assert [r["rank"] for r in run] == list(range(N))
    assert all(r["foreign"] == [] for r in run)
    assert {(r["backend"], r["device"]) for r in run} == {("gloo", "cpu")}


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_mesh_coordinates_and_groups(run, shape):
    data, model = (4, 1) if shape == "4x1" else (2, 2)
    for rank, r in enumerate(run):
        f = r[f"facts_{shape}"]
        d, m = divmod(rank, model)          # row-major, as jax.make_mesh
        assert f["shape"] == {"data": data, "model": model}
        assert f["coords"] == {"data": d, "model": m}
        assert f["data"]["index"] == d and f["model"]["index"] == m
        assert f["data+model"]["index"] == rank
        assert f["model+data"]["index"] == m * data + d
        assert f["data"]["members"] == [x * model + m for x in range(data)]
        assert f["model"]["members"] == [d * model + x for x in range(model)]
        assert f["data+model"]["members"] == list(range(N))


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_collectives_against_hand_values(run, shape):
    model = 1 if shape == "4x1" else 2
    for rank, r in enumerate(run):
        f = r[f"facts_{shape}"]
        for axes, key in (("data", "data"), ("model", "model"),
                          (("data", "model"), "data+model"),
                          (("model", "data"), "model+data")):
            members = f[key]["members"]
            order = sorted(members, key=lambda x: (
                run[x][f"facts_{shape}"][key]["index"]))
            assert f[key]["psum"] == sum(x + 1 for x in members)
            assert f[key]["pmean"] == pytest.approx(
                np.mean([x + 1 for x in members]), rel=1e-7)
            assert f[key]["gather"] == [float(x + 1) for x in order]
            assert f[key]["gather_ids"] == [[x, -1] for x in order]
        tree = f["tree"]
        n_data = 4 // model
        assert float(tree["a"]) == 2.0 * n_data
        assert torch.equal(tree["b"][0], torch.full((3,), float(n_data)))
        assert tree["b"][1] is None
        assert torch.equal(f["big"], torch.tensor([[1e30, -0.5]] * n_data))


def test_placement_blocks(run):
    g = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    for rank, r in enumerate(run):
        d, m = divmod(rank, 2)              # the (data 2, model 2) mesh
        p = r["placement"]
        assert torch.equal(p["constrain"], g[2 * d:2 * d + 2,
                                              3 * m:3 * m + 3])
        a, total = p["shard_map"]
        assert torch.equal(a, 2.0 * g)      # global, as jax.shard_map's
        assert float(total) == float(g.sum())
        assert torch.equal(p["shard_batch"]["xs"], g[2 * d:2 * d + 2])
        assert p["shard_batch"]["sim"].tolist() == \
            np.arange(24).reshape(4, 6)[2 * d:2 * d + 2].tolist()


def test_named_shape_still_raises():
    mesh = mesh_lib.make_local_mesh()
    for call in (lambda: partition.constrain(np.zeros(3), ("batch",), mesh),
                 lambda: partition.shard_map(lambda x: x, mesh, None, None),
                 lambda: partition.psum(torch.ones(1), "data", mesh)):
        with pytest.raises(NotImplementedError, match="fake_world"):
            call()
    with pytest.raises(RuntimeError, match="process group"):
        sync.make_worker_mesh(4)


# -- the PS over the worker mesh ----------------------------------------------

def _jax_state(mode, opt, L0):
    cfg = jax_sync.PSConfig(n_workers=N, **ranks.MODES[mode])
    return cfg, jax_sync.init_state(opt, jnp.asarray(L0), cfg)


@pytest.mark.parametrize("mode", list(ranks.MODES))
@pytest.mark.parametrize("make", ["sgd", "adam"])
def test_state_sharding_matches_reference(mode, make):
    L0 = np.zeros((ranks.PROJ, ranks.FEAT), np.float32)
    jopt = jax_optim.sgd(0.1) if make == "sgd" else jax_optim.adam(0.1)
    topt = optim.sgd(0.1) if make == "sgd" else optim.adam(0.1)
    cfg_r, st_r = _jax_state(mode, jopt, L0)
    ref = jax_sync.state_sharding(jax_sync.make_worker_mesh(1), cfg_r, st_r)
    cfg = sync.PSConfig(n_workers=N, **ranks.MODES[mode])
    specs = sync.state_sharding(None, cfg, sync.init_state(
        topt, torch.from_numpy(L0), cfg))
    assert specs.params == tuple(ref.params.spec)
    assert specs.step == tuple(ref.step.spec)
    assert [s for s in jax.tree.leaves(
        specs.opt_state, is_leaf=lambda x: type(x) is tuple)] == \
        [tuple(s.spec) for s in jax.tree.leaves(ref.opt_state)]
    if mode == "ssp":
        assert specs.grad_ring == tuple(ref.grad_ring.spec)
    else:
        assert specs.grad_ring is None and ref.grad_ring is None


def _one_process(inputs, mode):
    cfg = ranks.ps_config(mode)
    delays = inputs["delays"]
    return trainer.train_dml_distributed(
        cfg, ranks.dataset(), L0=inputs["L0"], delays=lambda t: delays[t],
        device="cpu")


@pytest.mark.parametrize("mode", list(ranks.MODES))
def test_ps_over_ranks_matches_reference(run, reference, inputs, mode):
    L1, hist1 = _one_process(inputs, mode)
    for r in run:
        res = r["ps"][mode]
        np.testing.assert_allclose(res["L"].numpy(), reference[f"L_{mode}"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(res["loss"], reference[f"loss_{mode}"],
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(res["L"], L1, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["loss"], [h["loss"] for h in hist1],
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(res["L"], run[0]["ps"][mode]["L"])
    assert run[0]["ps"][mode]["loss"][-1] < run[0]["ps"][mode]["loss"][0]


def test_chunk_over_ranks_matches_reference(run, reference, inputs):
    ps = sync.PSConfig(n_workers=N, sync="local", tau=ranks.CHUNK_TAU)
    batches = trainer.stack_worker_streams(trainer.make_worker_streams(
        ranks.dataset(), N, ranks.BATCH, seed=0, device="cpu"))
    steps = [next(batches) for _ in range(ranks.CHUNK_TAU)]
    one, m1 = sync.make_train_chunk(ranks.loss_fn, optim.sgd(ranks.LR), ps)(
        sync.init_state(optim.sgd(ranks.LR), torch.from_numpy(inputs["L0"]),
                        ps),
        {k: torch.stack([b[k] for b in steps], dim=1) for k in steps[0]})
    for r in run:
        c = r["ps"]["chunk"]
        assert c["step"] == ranks.CHUNK_TAU
        np.testing.assert_allclose(c["L"].numpy(), reference["L_chunk"][0],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(c["loss"], reference["loss_chunk"],
                                   rtol=1e-4)
        torch.testing.assert_close(c["L"], one.params[0], rtol=1e-5,
                                   atol=1e-6)
        assert c["loss"] == pytest.approx(float(m1["loss"]), rel=1e-6)
        assert torch.equal(c["L"], run[0]["ps"]["chunk"]["L"])


@pytest.mark.parametrize("mode", list(ranks.MODES))
def test_worker_copies_across_ranks(run, inputs, mode):
    """bsp: bit-identical every step; local and ssp: equal on sync steps
    and apart between them (tests/_ps_subprocess_check.py's checks); an
    ssp step after a sync leaves the copies apart exactly when the
    workers read different ring slots."""
    copies = [r["ps"][f"{mode}_copies"] for r in run]
    period = {"bsp": 1, "local": 2, "ssp": 2}[mode]
    drifted = 0
    for t in range(ranks.COPY_STEPS):
        same = all(torch.equal(c[t], copies[0][t]) for c in copies[1:])
        if (t + 1) % period == 0:
            assert same, f"{mode}: copies differ after sync step {t}"
            continue
        if mode == "ssp":
            reads = {(t - min(int(d), t)) % period
                     for d in inputs["delays"][t]}
            assert same == (len(reads) == 1), (t, reads)
        else:
            assert not same, f"{mode}: copies did not drift at step {t}"
        drifted += not same
    assert mode == "bsp" or drifted > 0
    merged = [r["ps"][f"{mode}_merged"] for r in run]
    assert all(torch.equal(m, merged[0]) for m in merged)
    torch.testing.assert_close(merged[0], copies[0][-1], rtol=1e-6,
                               atol=1e-7)


# -- the sharded galleries -----------------------------------------------------

@pytest.mark.parametrize("shape", ["4x1", "2x2"])
@pytest.mark.parametrize("k_top", ranks.KS)
def test_sharded_exact_matches_reference(run, jax_answers, shape, k_top):
    shards = 4 if shape == "4x1" else 2
    for r in run:
        res = r["exact"][shape]
        assert (res["n_shards"], res["rows"], res["size"]) == \
            (shards, 600 // shards, 600)
        _same_answers(res["answers"][k_top], jax_answers["exact"][k_top])


def test_sharded_exact_builds(run, jax_answers):
    for r in run:
        assert r["exact"]["build"]["n_shards"] == 4
        _same_answers(r["exact"]["build"]["answers"],
                      jax_answers["exact"][10])


def test_rows_that_do_not_divide_are_replicated(run, inputs):
    jidx = JaxExactIndex.build(jnp.asarray(inputs["L"]),
                               jnp.asarray(inputs["G"][:-2]))
    ref = jidx.topk(jnp.asarray(inputs["q"]), 10)
    for r in run:
        assert r["exact"]["ragged"]["n_shards"] == 1
        assert r["exact"]["ragged"]["rows"] == 598
        _same_answers(r["exact"]["ragged"]["answers"], ref)


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
@pytest.mark.parametrize("nprobe", ranks.NPROBES)
def test_sharded_ivf_matches_reference(run, jax_answers, shape, nprobe):
    shards = 4 if shape == "4x1" else 2
    cap = jax_answers["ivf_cap"]
    for r in run:
        res = r["ivf"][shape]
        assert (res["n_shards"], res["n_clusters"], res["cap"]) == \
            (shards, 8, cap)
        assert res["pad_rows"] == (8 // shards + 1) * cap   # + sentinel
        _same_answers(res["answers"][nprobe], jax_answers["ivf"][nprobe])


def test_sharded_ivf_refuses_bad_arguments_on_every_rank(run):
    for r in run:
        too_many, too_narrow = r["ivf"]["refused"]
        assert "n_clusters=" in too_many and "> gallery size" in too_many
        assert "projected rows have dim 11" in too_narrow


@pytest.mark.parametrize("which", ["exact", "ivf"])
def test_engine_on_rank_0_with_followers(run, inputs, jax_answers, which):
    if which == "exact":
        ref = JaxExactIndex.build(jnp.asarray(inputs["L"]),
                                  jnp.asarray(inputs["G"])).topk(
            jnp.asarray(inputs["q"]), 7)
    else:
        ref = jax_answers["ivf"][8][0][:, :7], jax_answers["ivf"][8][1][:, :7]
    lead = run[0]["served"][which]
    assert lead["n_shards"] == 4
    _same_answers(lead["answers"], ref)
    _same_answers((lead["single"][0][None], lead["single"][1][None]),
                  (np.asarray(ref[0])[:1], np.asarray(ref[1])[:1]))
    # warmup's 2 buckets, one batch, one single query (bucket 8)
    assert [r["served"][which]["followed"] for r in run[1:]] == [4] * 3


# -- the CLI, failures, no card ------------------------------------------------

@pytest.mark.parametrize("index", ["exact", "ivf"])
def test_serve_retrieval_data_4_matches_data_1(index):
    argv = ["--device", "cpu", "--gallery-size", "600", "--train-steps",
            "20", "--requests", "40", "--feat-dim", "24", "--proj-dim",
            "12", "--index", index, "--n-clusters", "8", "--nprobe", "3"]
    one = serve_retrieval.main(argv)
    four = serve_retrieval.main(argv + ["--data", "4"])
    assert sorted(one) == sorted(four) == list(range(40))
    for i in one:
        np.testing.assert_array_equal(one[i], four[i])


@pytest.mark.parametrize("flags", [["--tenants", "2"], ["--mutable"],
                                   ["--snapshot-dir", "x"],
                                   ["--index", "ivfpq"],
                                   ["--index", "ivf", "--scan-impl",
                                    "pallas"]])
def test_serve_retrieval_data_refusals(flags):
    with pytest.raises(SystemExit):
        serve_retrieval.main(["--device", "cpu", "--data", "2"] + flags)


def test_a_failed_rank_fails_the_call():
    t0 = time.perf_counter()
    with pytest.raises(mesh_lib.RankError,
                       match=r"(?s)rank 1 of 2 failed.*fails on purpose"):
        mesh_lib.spawn(ranks.fail_on, 2, device="cpu", args=(1,),
                       timeout=60.0)
    assert time.perf_counter() - t0 < 60.0


def test_a_collective_past_its_timeout_fails_the_call():
    t0 = time.perf_counter()
    with pytest.raises(mesh_lib.RankError, match="rank 0 of 2 failed"):
        mesh_lib.spawn(ranks.stall, 2, device="cpu", timeout=10.0)
    assert time.perf_counter() - t0 < 60.0


def test_a_call_failing_on_rank_0_ends_the_group(inputs):
    """The follower fails at once (its collective's peer is gone), not
    after the 30 s timeout; rank 0 ended the group."""
    inp = {"L": inputs["L"], "gp": inputs["gp"][:40],
           "gn": inputs["gn"][:40], "q": inputs["q"][:4]}
    t0 = time.perf_counter()
    with pytest.raises(mesh_lib.RankError, match="rank 1 of 2 failed"):
        mesh_lib.spawn(ranks.fail_while_leading, 2, device="cpu",
                       args=(inp,), timeout=30.0)
    assert time.perf_counter() - t0 < 30.0


def test_no_card_raises_before_any_rank_starts(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.spawn(ranks.fail_on, 2, args=(0,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_retrieval.main(["--data", "2", "--gallery-size", "100"])


if __name__ == "__main__":
    _reference_runs(sys.argv[1])
