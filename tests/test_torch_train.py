"""The port's training path (repro_torch) held against the JAX reference.

The same numpy inputs go through both packages:
  * ``core/dml``, ``core/losses``, ``optim`` and its schedules: values,
    gradients and several optimizer steps within rtol 1e-5;
  * ``data/pairs`` and ``data/loader``: the same ``RandomState`` draws,
    so indices and batch rows must be byte-identical;
  * ``train_dml_single`` and ``train_dml_distributed``: the reference's
    initial factor L0 (drawn from ``jax.random``, which the port cannot
    reproduce) is carried across, and the trained L must agree within
    rtol 1e-4. P = 1 runs in process. For P = 4 under bsp, local and ssp
    this file runs itself as a subprocess with 8 forced host devices set
    before JAX is imported (as tests/_ps_subprocess_check.py does); the
    subprocess writes the reference's L, losses and SSP delay draws to an
    npz, and the port is fed the same pairs, L0 and delays.

Run as a script (``python tests/test_torch_train.py OUT.npz``) it is that
subprocess.
"""

import os
import subprocess
import sys

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
from repro.data import pairs as jax_pairs
from repro import optim as jax_optim

from repro_torch import convert
from repro_torch import optim
from repro_torch.core import dml, losses
from repro_torch.core.ps import sync, trainer
from repro_torch.data import loader, pairs
from repro_torch.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
P4_STEPS = 20
P4_MODES = {"bsp": dict(sync="bsp"), "local": dict(sync="local", tau=4),
            "ssp": dict(sync="ssp", staleness=3)}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(ours, theirs, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=rtol, atol=atol)


def _dataset(n=400, d=24, classes=4, seed=0):
    cfg = pairs.PairDatasetConfig(n_samples=n, feat_dim=d, n_classes=classes,
                                  noise=1.0, seed=seed)
    return cfg, pairs.train_eval_split(cfg, 1500, 1500, 400, 400)


# -- core/dml and losses -----------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    B, k, d = 40, 6, 10
    return dict(L=(0.3 * rng.randn(k, d)).astype(np.float32),
                xs=rng.randn(B, d).astype(np.float32),
                ys=rng.randn(B, d).astype(np.float32),
                neg=rng.randn(B, d).astype(np.float32),
                sim=(rng.rand(B) < 0.5).astype(np.int32))


@pytest.mark.parametrize("name", ["mahalanobis_sqdist", "pair_losses",
                                  "objective", "objective_full",
                                  "analytic_grad", "pair_scores"])
def test_dml_pair_functions_match_jax(batch, name):
    L, xs, ys, sim = batch["L"], batch["xs"], batch["ys"], batch["sim"]
    args = (L, xs, ys) if name in ("mahalanobis_sqdist", "pair_scores") \
        else (L, xs, ys, sim, 1.3, 3.0)
    ours = getattr(dml, name)(*(_t(a) if isinstance(a, np.ndarray) else a
                                for a in args))
    theirs = getattr(jax_dml, name)(*(jnp.asarray(a)
                                      if isinstance(a, np.ndarray) else a
                                      for a in args))
    _close(ours.numpy(), theirs)


def test_objective_value_and_grad_matches_jax(batch):
    args = [batch[k] for k in ("L", "xs", "ys", "sim")]
    val, g = dml.objective_value_and_grad(*map(_t, args), 1.3, 3.0)
    val_r, g_r = jax_dml.objective_value_and_grad(
        *map(jnp.asarray, args), 1.3, 3.0)
    _close(val.numpy(), val_r)
    _close(g.numpy(), g_r)
    _close(g.numpy(), dml.analytic_grad(*map(_t, args), 1.3, 3.0).numpy())


def test_bf16_compute_dtype_matches_jax(batch):
    args = [batch[k] for k in ("L", "xs", "ys", "sim")]
    ours = dml.objective(*map(_t, args), compute_dtype=torch.bfloat16)
    theirs = jax_dml.objective(*map(jnp.asarray, args),
                               compute_dtype=jnp.bfloat16)
    _close(ours.numpy(), theirs, rtol=2e-2)


def test_original_formulation_pieces_match_jax(batch):
    L, xs, ys = batch["L"], batch["xs"], batch["ys"]
    M = dml.M_from_L(_t(L))
    _close(M.numpy(), jax_dml.M_from_L(jnp.asarray(L)))
    _close(dml.mahalanobis_sqdist_M(M, _t(xs), _t(ys)).numpy(),
           jax_dml.mahalanobis_sqdist_M(jnp.asarray(M.numpy()),
                                        jnp.asarray(xs), jnp.asarray(ys)),
           rtol=1e-4)
    _close(dml.pair_scores_M(M, _t(xs), _t(ys)).numpy(),
           jax_dml.pair_scores_M(jnp.asarray(M.numpy()), jnp.asarray(xs),
                                 jnp.asarray(ys)), rtol=1e-4)
    S = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    _close(dml.psd_project(_t(S)).numpy(),
           jax_dml.psd_project(jnp.asarray(S)), rtol=1e-4, atol=1e-5)
    assert torch.linalg.eigvalsh(dml.psd_project(_t(S))).min() > -1e-5


def test_triplets_and_scores_match_jax(batch):
    L, xs, ys, neg = batch["L"], batch["xs"], batch["ys"], batch["neg"]
    _close(dml.triplet_losses(_t(L), _t(xs), _t(ys), _t(neg), 2.0).numpy(),
           jax_dml.triplet_losses(jnp.asarray(L), jnp.asarray(xs),
                                  jnp.asarray(ys), jnp.asarray(neg), 2.0))
    _close(dml.triplet_objective(_t(L), _t(xs), _t(ys), _t(neg)).numpy(),
           jax_dml.triplet_objective(jnp.asarray(L), jnp.asarray(xs),
                                     jnp.asarray(ys), jnp.asarray(neg)))
    _close(dml.pair_scores_euclidean(_t(xs), _t(ys)).numpy(),
           jax_dml.pair_scores_euclidean(jnp.asarray(xs), jnp.asarray(ys)))


def test_average_precision_and_pr_curve_match_jax(batch):
    rng = np.random.RandomState(1)
    scores = rng.randint(0, 6, 50).astype(np.float32)       # many ties
    labels = (rng.rand(50) < 0.4).astype(np.int32)
    _close(dml.average_precision(_t(scores), _t(labels)).numpy(),
           jax_dml.average_precision(jnp.asarray(scores),
                                     jnp.asarray(labels)))
    for ours, theirs in zip(dml.precision_recall_curve(_t(scores), labels, 20),
                            jax_dml.precision_recall_curve(scores, labels,
                                                           20)):
        np.testing.assert_array_equal(ours, theirs)


def test_dml_pair_loss_and_aux_match_jax(batch):
    b = {k: batch[k] for k in ("xs", "ys", "sim")}
    loss, aux = losses.get("dml_pair")(_t(batch["L"]),
                                       tree_map(_t, b), lam=1.3, margin=3.0)
    loss_r, aux_r = jax_losses.get("dml_pair")(
        jnp.asarray(batch["L"]), {k: jnp.asarray(v) for k, v in b.items()},
        lam=1.3, margin=3.0)
    _close(loss.detach().numpy(), loss_r)
    assert set(aux) == set(aux_r)
    for k in aux:
        _close(aux[k].numpy(), aux_r[k])


def test_dml_pair_loss_bf16_compute_dtype_matches_jax(batch):
    """compute_dtype bf16 takes the reference's cast-and-product path (on
    the card too, where the f32 loss is the kernel). bf16 operands keep 8
    mantissa bits and the two frameworks sum the bf16 products in another
    order, so the loss is held at rtol 2e-2, as the bf16 objective above;
    the aux statistics use the f32 d2 on both sides."""
    b = {k: batch[k] for k in ("xs", "ys", "sim")}
    loss, aux = losses.dml_pair_loss(_t(batch["L"]), tree_map(_t, b),
                                     lam=1.3, margin=3.0,
                                     compute_dtype=torch.bfloat16)
    loss_r, aux_r = jax_losses.dml_pair_loss(
        jnp.asarray(batch["L"]), {k: jnp.asarray(v) for k, v in b.items()},
        lam=1.3, margin=3.0, compute_dtype=jnp.bfloat16)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    _close(loss.detach().numpy(), loss_r, rtol=2e-2)
    assert set(aux) == set(aux_r)
    for k in aux:
        _close(aux[k].numpy(), aux_r[k])


def test_triplet_and_lm_losses_match_jax(batch):
    trip = {"anchor": batch["xs"], "pos": batch["ys"], "neg": batch["neg"]}
    ours, _ = losses.get("dml_triplet")(_t(batch["L"]), tree_map(_t, trip))
    theirs, _ = jax_losses.get("dml_triplet")(
        jnp.asarray(batch["L"]), {k: jnp.asarray(v) for k, v in trip.items()})
    _close(ours.numpy(), theirs)
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.rand(3, 5) < 0.7).astype(np.float32)
    for m in (None, mask):
        lb = {"labels": labels} if m is None else {"labels": labels,
                                                   "mask": m}
        ours, _ = losses.get("lm")(_t(logits), tree_map(_t, lb))
        theirs, _ = jax_losses.get("lm")(
            jnp.asarray(logits), {k: jnp.asarray(v) for k, v in lb.items()})
        _close(ours.numpy(), theirs)
    with pytest.raises(KeyError, match="unknown loss"):
        losses.get("nope")


# -- optim -------------------------------------------------------------------

def _optimizers(lib):
    s = lib.schedules
    return {
        "sgd": lib.sgd(0.1),
        "sgd_inverse_time": lib.sgd(s.inverse_time(0.1, 0.5)),
        "momentum": lib.momentum(s.constant(0.05)),
        "nesterov": lib.momentum(0.05, beta=0.8, nesterov=True),
        "adam": lib.adam(s.cosine(0.01, 6, warmup=2, floor=0.1)),
        "adamw": lib.adamw(s.linear_warmup(0.01, 3), weight_decay=0.1),
    }


@pytest.mark.parametrize("name", list(_optimizers(optim)))
def test_optimizer_steps_match_jax(name):
    rng = np.random.RandomState(4)
    params = {"L": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(6)]
    ours_opt, ref_opt = _optimizers(optim)[name], _optimizers(jax_optim)[name]
    p, pr = tree_map(_t, params), jax.tree.map(jnp.asarray, params)
    s, sr = ours_opt.init(p), ref_opt.init(pr)
    for g in grads:
        u, s = ours_opt.update(tree_map(_t, g), s, p)
        p = optim.apply_updates(p, u)
        ur, sr = ref_opt.update(jax.tree.map(jnp.asarray, g), sr, pr)
        pr = jax_optim.apply_updates(pr, ur)
    for k in params:
        _close(p[k].numpy(), pr[k])
    assert int(tree_leaves(s)[0]) == int(jax.tree.leaves(sr)[0]) == 6


def test_clip_by_global_norm_matches_jax():
    rng = np.random.RandomState(5)
    g = {"a": rng.randn(3, 4).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        ours, gn = optim.clip_by_global_norm(tree_map(_t, g), max_norm)
        theirs, gn_r = jax_optim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), max_norm)
        _close(gn.numpy(), gn_r)
        for k in g:
            _close(ours[k].numpy(), theirs[k])


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("inverse_time", (0.1, 1e-3)),
    ("cosine", (0.2, 100, 10, 0.05)), ("cosine", (0.2, 50)),
    ("linear_warmup", (0.4, 20))])
def test_schedules_match_jax(name, args):
    ours = getattr(optim.schedules, name)(*args)
    theirs = getattr(jax_optim.schedules, name)(*args)
    for step in (0, 1, 5, 10, 37, 50, 100, 1000):
        _close(ours(torch.tensor(step, dtype=torch.int32)).numpy(),
               theirs(jnp.asarray(step, jnp.int32)))


# -- data --------------------------------------------------------------------

def _same(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dedup", [True, False])
def test_pair_sampling_byte_identical(dedup):
    x, y = pairs.make_features(pairs.PairDatasetConfig(300, 12, 5, seed=1))
    ours = pairs.sample_pairs(x, y, 700, 900, seed=3, dedup=dedup)
    theirs = jax_pairs.sample_pairs(x, y, 700, 900, seed=3, dedup=dedup)
    for k in theirs:
        _same(ours[k], theirs[k])
    ours = pairs.sample_pair_indices(y, 500, 800, seed=4, dedup=dedup)
    theirs = jax_pairs.sample_pair_indices(y, 500, 800, seed=4, dedup=dedup)
    for k in theirs:
        _same(ours[k], theirs[k])


def test_exhausted_pool_raises_like_the_reference():
    y = np.array([0, 0, 1, 1], np.int32)
    with pytest.raises(ValueError, match="distinct similar pairs") as ours:
        pairs.sample_pair_indices(y, 5, 1)
    with pytest.raises(ValueError) as theirs:
        jax_pairs.sample_pair_indices(y, 5, 1)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n_pool,size", [(10, 20), (100, 30), (10000, 50)])
def test_distinct_draws_byte_identical(n_pool, size):
    _same(pairs.distinct_draws(np.random.RandomState(7), n_pool, size),
          jax_pairs.distinct_draws(np.random.RandomState(7), n_pool, size))


@pytest.mark.parametrize("balanced", [True, False])
def test_batch_streams_byte_identical(balanced):
    cfg, (train, _) = _dataset()
    ours = pairs.pair_batches(train, 64, seed=5, balanced=balanced,
                              device="cpu")
    theirs = jax_pairs.pair_batches(train, 64, seed=5, balanced=balanced)
    x, y = pairs.make_features(cfg)
    idx = pairs.sample_pair_indices(y, 600, 600, seed=2)
    ours_i = pairs.pair_batches_from_indices(x, idx, 50, seed=6,
                                             balanced=balanced, device="cpu")
    theirs_i = jax_pairs.pair_batches_from_indices(x, idx, 50, seed=6,
                                                   balanced=balanced)
    for _ in range(4):
        for o, t in ((next(ours), next(theirs)), (next(ours_i),
                                                  next(theirs_i))):
            assert set(o) == set(t)
            for k in t:
                _same(o[k], t[k])


def test_train_eval_split_and_triplets_byte_identical():
    cfg = pairs.PairDatasetConfig(300, 16, 6, kind="mnist_like", seed=2)
    ref_cfg = jax_pairs.PairDatasetConfig(300, 16, 6, kind="mnist_like",
                                          seed=2)
    for o, t in zip(pairs.train_eval_split(cfg, 400, 500, 60, 70),
                    jax_pairs.train_eval_split(ref_cfg, 400, 500, 60, 70)):
        for k in t:
            _same(o[k], t[k])
    x, y = pairs.make_features(cfg)
    ti = pairs.sample_triplet_indices(y, 333, seed=8)
    ti_r = jax_pairs.sample_triplet_indices(y, 333, seed=8)
    for k in ti_r:
        _same(ti[k], ti_r[k])
    ours = pairs.triplet_batches_from_indices(x, ti, 32, seed=9, device="cpu")
    theirs = jax_pairs.triplet_batches_from_indices(x, ti_r, 32, seed=9)
    for _ in range(3):
        o, t = next(ours), next(theirs)
        for k in t:
            _same(o[k], t[k])


def test_loader_matches_reference():
    _, (train, _) = _dataset()
    for n in (1, 3, 4):
        for o, t in zip(loader.partition_pairs(train, n),
                        jax_loader.partition_pairs(train, n)):
            for k in t:
                _same(o[k], t[k])
    assert list(loader.take(iter(range(10)), 4)) == \
        list(jax_loader.take(iter(range(10)), 4))
    pf = loader.Prefetcher(iter(range(50)), depth=3)
    assert list(pf) == list(range(50))
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


# -- trainers ----------------------------------------------------------------

def test_train_dml_single_matches_jax():
    _, (train, ev) = _dataset()
    dcfg = dml.DMLConfig(feat_dim=24, proj_dim=12)
    kw = dict(steps=20, batch_size=128, lr=5e-2, seed=0, eval_every=5)
    L_ref, h_ref = jax_trainer.train_dml_single(
        jax_dml.DMLConfig(feat_dim=24, proj_dim=12), train, eval_pairs=ev,
        **kw)
    L0 = np.asarray(jax_dml.init_params(
        jax_dml.DMLConfig(feat_dim=24, proj_dim=12), jax.random.PRNGKey(0)))
    L, h = trainer.train_dml_single(dcfg, train, eval_pairs=ev, L0=L0,
                                    device="cpu", **kw)
    _close(L.numpy(), L_ref, rtol=1e-4)
    assert len(h) == len(h_ref) == 20
    _close([r["loss"] for r in h], [r["loss"] for r in h_ref], rtol=1e-4)
    _close([r["ap"] for r in h if "ap" in r],
           [r["ap"] for r in h_ref if "ap" in r], rtol=1e-4)
    assert h[-1]["loss"] < h[0]["loss"]


def test_train_dml_distributed_one_worker_matches_jax():
    _, (train, _) = _dataset()
    kw = dict(batch_size=128, steps=15, lr=5e-2, log_every=4)
    ref_cfg = jax_trainer.DMLTrainConfig(
        dml=jax_dml.DMLConfig(feat_dim=24, proj_dim=12),
        ps=jax_sync.PSConfig(n_workers=1), **kw)
    L_ref, h_ref = jax_trainer.train_dml_distributed(ref_cfg, train)
    L0 = np.asarray(jax_dml.init_params(ref_cfg.dml, jax.random.PRNGKey(0)))
    cfg = trainer.DMLTrainConfig(dml=dml.DMLConfig(feat_dim=24, proj_dim=12),
                                 ps=sync.PSConfig(n_workers=1), **kw)
    L, h = trainer.train_dml_distributed(cfg, train, L0=L0, device="cpu")
    _close(L.numpy(), L_ref, rtol=1e-4)
    assert [r["step"] for r in h] == [r["step"] for r in h_ref]
    assert set(h[0]) == set(h_ref[0])
    for r, rr in zip(h, h_ref):
        for k in rr:
            _close(r[k], rr[k], rtol=1e-4, atol=1e-5)


def _port_state_step(mode, n_steps, delays=None, seed=0):
    """A P=4 port PS state after ``n_steps`` steps, and its step fn."""
    _, (train, _) = _dataset()
    ps = sync.PSConfig(n_workers=4, **P4_MODES[mode])
    L0 = dml.init_params(dml.DMLConfig(feat_dim=24, proj_dim=12),
                         torch.Generator().manual_seed(seed), "cpu")
    state = sync.init_state(optim.sgd(0.05), L0, ps)
    step = sync.make_train_step(lambda p, b: losses.dml_pair_loss(p, b),
                                optim.sgd(0.05), ps, delays=delays)
    batches = trainer.stack_worker_streams(trainer.make_worker_streams(
        train, 4, 64, seed=seed, device="cpu"))
    for _ in range(n_steps):
        state, _ = step(state, next(batches))
    return state, step, batches


def test_bsp_copies_stay_bitwise_equal():
    state, _, _ = _port_state_step("bsp", 3)
    for w in range(1, 4):
        assert torch.equal(state.params[0], state.params[w])
    assert state.step == 3 and int(state.opt_state.step[0]) == 3


def test_local_copies_drift_and_merge():
    state, step, batches = _port_state_step("local", 2)      # tau = 4
    assert float((state.params[0] - state.params[1]).abs().max()) > 1e-7
    for _ in range(2):
        state, _ = step(state, next(batches))
    for w in range(1, 4):
        assert torch.equal(state.params[0], state.params[w])


def test_ssp_reads_the_delayed_slot():
    # s = 3: the copies merge after step 2; at step 3 (no merge) each
    # worker applies the ring slot its delay names
    state, _, _ = _port_state_step(
        "ssp", 4, delays=lambda t: torch.tensor([0, 1, 2, 2]))
    assert state.grad_ring.shape == (4, 3, 12, 24)
    assert torch.equal(state.grad_ring[0], state.grad_ring[3])
    assert torch.equal(state.params[2], state.params[3])     # same delay
    assert not torch.equal(state.params[0], state.params[1])
    assert not torch.equal(state.params[1], state.params[2])
    state, _, _ = _port_state_step(
        "ssp", 3, delays=lambda t: torch.tensor([0, 1, 2, 2]))
    for w in range(1, 4):                                     # merged
        assert torch.equal(state.params[0], state.params[w])


def test_chunked_local_sgd_equals_stepwise():
    _, (train, _) = _dataset()
    ps = sync.PSConfig(n_workers=2, sync="local", tau=3)
    L0 = dml.init_params(dml.DMLConfig(feat_dim=24, proj_dim=12),
                         torch.Generator().manual_seed(1), "cpu")
    loss_fn = lambda p, b: losses.dml_pair_loss(p, b)       # noqa: E731
    batches = trainer.stack_worker_streams(trainer.make_worker_streams(
        train, 2, 32, seed=0, device="cpu"))
    steps = [next(batches) for _ in range(3)]
    s1 = sync.init_state(optim.sgd(0.05), L0, ps)
    step = sync.make_train_step(loss_fn, optim.sgd(0.05), ps)
    s1, hist = sync.run_steps(step, s1, iter(steps), 3)
    chunk = {k: torch.stack([b[k] for b in steps], dim=1) for k in steps[0]}
    s2, m = sync.make_train_chunk(loss_fn, optim.sgd(0.05), ps)(
        sync.init_state(optim.sgd(0.05), L0, ps), chunk)
    assert s1.step == s2.step == 3 and len(hist) == 3
    torch.testing.assert_close(s1.params, s2.params, rtol=1e-6, atol=1e-7)
    _close(float(m["loss"]), np.mean([h["loss"] for h in hist]), rtol=1e-5)


def test_state_carried_from_jax_steps_like_jax():
    _, (train, _) = _dataset()
    dcfg = jax_dml.DMLConfig(feat_dim=24, proj_dim=12)
    L0 = jax_dml.init_params(dcfg, jax.random.PRNGKey(3))
    batch = next(jax_trainer._stacked_batches(
        jax_loader.partition_pairs(train, 1), 64, seed=0))
    for make in (lambda lib: lib.momentum(0.05, nesterov=True),
                 lambda lib: lib.adam(0.01), lambda lib: lib.sgd(0.05)):
        ps_r = jax_sync.PSConfig(n_workers=1, sync="ssp", staleness=2)
        st_r = jax_sync.init_state(make(jax_optim), L0, ps_r)
        step_r = jax_sync.make_train_step(
            lambda p, b: jax_losses.dml_pair_loss(p, b), make(jax_optim),
            ps_r, jax_sync.make_worker_mesh(1))
        st_r, _ = step_r(st_r, batch)                # one step in the ref
        st = convert.ps_state_from_jax(jax.tree.map(np.asarray, st_r),
                                       device="cpu")
        _same(st.params, st_r.params)
        _same(st.grad_ring, st_r.grad_ring)
        for o, t in zip(tree_leaves(st.opt_state),
                        jax.tree.leaves(st_r.opt_state)):
            _same(o, t)
        assert st.step == 1
        # the next step in both, with the reference's delay draw
        key = jax.random.fold_in(jax.random.fold_in(st_r.rng, 1), 0)
        delay = int(jax.random.randint(key, (), 0, 2))
        st_r, _ = step_r(st_r, batch)
        step = sync.make_train_step(
            lambda p, b: losses.dml_pair_loss(p, b), make(optim),
            sync.PSConfig(n_workers=1, sync="ssp", staleness=2),
            delays=lambda t: [delay])
        st, _ = step(st, tree_map(lambda x: _t(np.asarray(x)), batch))
        _close(st.params.numpy(), st_r.params, rtol=1e-5)
    with pytest.raises(ValueError, match="not a ScaleState"):
        convert.opt_state_from_jax(st_r, device="cpu")


# -- P = 4 against the reference, in a subprocess -----------------------------

def _reference_runs(out_path):
    """The subprocess: P = 4 reference runs under each sync model."""
    assert jax.device_count() == 8, jax.device_count()
    _, (train, _) = _dataset()
    dcfg = jax_dml.DMLConfig(feat_dim=24, proj_dim=12)
    out = {"L0": np.asarray(jax_dml.init_params(dcfg, jax.random.PRNGKey(0)))}
    for mode, kw in P4_MODES.items():
        cfg = jax_trainer.DMLTrainConfig(
            dml=dcfg, ps=jax_sync.PSConfig(n_workers=4, **kw),
            batch_size=64, steps=P4_STEPS, lr=5e-2, log_every=1)
        L, hist = jax_trainer.train_dml_distributed(cfg, train)
        out[f"L_{mode}"] = np.asarray(L)
        out[f"loss_{mode}"] = np.array([h["loss"] for h in hist])
    # sync.py's SSP draw: fold_in(fold_in(PRNGKey(seed), step), worker)
    key = jax.random.PRNGKey(0)
    out["delays"] = np.array(
        [[int(jax.random.randint(jax.random.fold_in(
            jax.random.fold_in(key, t), w), (), 0,
            P4_MODES["ssp"]["staleness"])) for w in range(4)]
         for t in range(P4_STEPS)])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference_p4(tmp_path_factory):
    out = tmp_path_factory.mktemp("p4") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return dict(np.load(out))


@pytest.mark.slow
@pytest.mark.parametrize("mode", list(P4_MODES))
def test_four_workers_match_jax(reference_p4, mode):
    _, (train, _) = _dataset()
    ref = reference_p4
    cfg = trainer.DMLTrainConfig(
        dml=dml.DMLConfig(feat_dim=24, proj_dim=12),
        ps=sync.PSConfig(n_workers=4, **P4_MODES[mode]),
        batch_size=64, steps=P4_STEPS, lr=5e-2, log_every=1)
    L, hist = trainer.train_dml_distributed(
        cfg, train, L0=ref["L0"], delays=lambda t: ref["delays"][t],
        device="cpu")
    _close(L.numpy(), ref[f"L_{mode}"], rtol=1e-4)
    _close([h["loss"] for h in hist], ref[f"loss_{mode}"], rtol=1e-4,
           atol=1e-5)
    assert hist[-1]["loss"] < hist[0]["loss"]


if __name__ == "__main__":
    _reference_runs(sys.argv[1])
