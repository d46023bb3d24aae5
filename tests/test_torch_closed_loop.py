"""The port's closed loop held against the JAX reference, on the CPU.

Both packages run ``ClosedLoopTrainer`` from one L0 (the reference's
``jax.random`` draw, carried across with ``L0=``) and one configuration
(``convert.closed_loop_config_from_jax``), at P = 1, over
``mutable-exact``, ``mutable-ivf`` (every cluster probed) and a frozen
``exact`` index, for 30 steps with a refresh every 10, and under the
plateau policy. The refresh records must be equal (pool, step,
``index_version``, every mined count), and so must each step record's
``staleness``, ``mined_frac`` and ``pool_size``; the losses and the final
L agree within rtol 1e-5, atol 1e-6 (f32: the two packages sum the Eq. 4
products in different orders, and the mined pools, being equal, do not
amplify that). A run through a tenant router promotes the same metrics.

Then the reference's ``TestClosedLoop``, ``TestClosedLoopRouter`` and
``TestConvergenceSmoke`` (tests/test_mining.py) on the port; the
shadow-promoted view is bit-identical to a fresh build. Last, the
command lines: ``train_mined`` and ``serve_retrieval --mine 64`` (with
and without ``--scheduler``) in a subprocess with ``--device cpu``, and
``metrics_report`` rendering a port-written snapshot as the same text as
the reference's renders it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dml as jax_dml
from repro.core.ps import sync as jax_sync
from repro.core.ps.trainer import DMLTrainConfig as JaxTrainConfig
from repro.data import pairs as jax_pairs
from repro.launch import metrics_report as jax_report
from repro.mining import ClosedLoopConfig as JaxLoopConfig
from repro.mining import ClosedLoopTrainer as JaxLoop
from repro.mining import CurriculumSchedule as JaxSchedule
from repro.mining import MinerConfig as JaxMinerConfig
from repro.serve import TenantRouter as JaxRouter

from repro_torch.convert import closed_loop_config_from_jax
from repro_torch.core import dml, eval_tasks
from repro_torch.core.ps import sync
from repro_torch.core.ps.trainer import DMLTrainConfig, train_dml_distributed
from repro_torch.data import pairs as pairdata
from repro_torch.launch import metrics_report
from repro_torch.mining import (ClosedLoopConfig, ClosedLoopTrainer,
                                CurriculumSchedule, MinerConfig)
from repro_torch.serve import (ExactIndex, MutableIndex, RetrievalEngine,
                               TenantRouter)

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
TIMED = ("mine_busy_s", "engine_qps")


def _blobs(n=600, d=16, c=6, noise=0.3, seed=0):
    cfg = jax_pairs.PairDatasetConfig(n_samples=n, feat_dim=d, n_classes=c,
                                      kind="class_blobs", noise=noise,
                                      seed=seed)
    return jax_pairs.make_features(cfg)


def _jax_cfg(d=16, steps=30, log_every=1, **kw):
    return JaxLoopConfig(
        train=JaxTrainConfig(dml=jax_dml.DMLConfig(feat_dim=d, proj_dim=8),
                             ps=jax_sync.PSConfig(n_workers=1),
                             batch_size=64, steps=steps, lr=1e-2,
                             log_every=log_every),
        miner=JaxMinerConfig(k_neighbors=10),
        schedule=JaxSchedule(warmup_steps=4, ramp_steps=8,
                             max_mined_frac=0.5),
        mine_queries=128, **kw)


def _assert_same_runs(jt, hj, Lj, pt, hp, Lp):
    assert len(hp["refreshes"]) == len(hj["refreshes"]) >= 2
    for rp, rj in zip(hp["refreshes"], hj["refreshes"]):
        assert set(rp) == set(rj)
        for key in rj:
            if key not in TIMED and key != "shadow":
                assert rp[key] == rj[key], key
    for key in ("a", "b", "sim"):
        np.testing.assert_array_equal(pt.source._pool[key],
                                      jt.source._pool[key])
    assert len(hp["steps"]) == len(hj["steps"])
    for sp, sj in zip(hp["steps"], hj["steps"]):
        for key in ("step", "staleness", "mined_frac", "pool_size"):
            assert sp[key] == sj[key], key
        np.testing.assert_allclose(sp["loss"], sj["loss"], **TOL)
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), **TOL)
    sp, sj = hp["summary"], hj["summary"]
    for key in ("n_refreshes", "mean_staleness", "total_mined_pairs",
                "neg_yield", "pos_yield"):
        assert sp[key] == sj[key], key
    for key in ("n_queries", "n_device_queries", "gallery_size",
                "cache_hits", "cache_misses", "index"):
        assert sp["engine"][key] == sj["engine"][key], key


LOOPS = {
    "mutable-exact": dict(index="mutable-exact", refresh_every=10),
    "mutable-ivf": dict(index="mutable-ivf", refresh_every=10,
                        index_kwargs=dict(n_clusters=8, nprobe=8)),
    "exact": dict(index="exact", refresh_every=10),
    "plateau": dict(refresh_every=0, plateau_window=6, plateau_tol=0.5,
                    min_refresh_gap=5),
}


@pytest.mark.parametrize("name", list(LOOPS))
def test_loop_matches_reference(name):
    x, y = _blobs(n=400)
    jcfg = _jax_cfg(**LOOPS[name])
    jt = JaxLoop(jcfg, x, y)
    Lj, hj = jt.run()
    pt = ClosedLoopTrainer(closed_loop_config_from_jax(jcfg), x, y,
                           L0=np.asarray(jt.L0), device=CPU)
    Lp, hp = pt.run()
    _assert_same_runs(jt, hj, Lj, pt, hp, Lp)
    assert type(pt.engine.index).__name__ == \
        type(jt.engine.index).__name__
    assert pt.engine.index.version == jt.engine.index.version
    assert len(pt.timings) == pt.n_refreshes
    if name.startswith("mutable"):
        assert pt.engine.index.n_swaps == jt.engine.index.n_swaps >= 2
        assert {"host_to_device", "project", "rebuild", "mine"} <= \
            set(pt.timings[-1])


def test_loop_through_a_router_matches_reference():
    """Each refresh registers the fresh L as the tenant's shadow arm,
    mirrors the same seeded probes and promotes: both packages promote
    the same factors and mine the same pools."""
    x, y = _blobs(n=300, d=8, c=4)
    jcfg = JaxLoopConfig(
        train=JaxTrainConfig(dml=jax_dml.DMLConfig(feat_dim=8, proj_dim=4),
                             ps=jax_sync.PSConfig(n_workers=1),
                             batch_size=64, steps=21, lr=1e-2,
                             log_every=1),
        miner=JaxMinerConfig(k_neighbors=10),
        schedule=JaxSchedule(warmup_steps=2, ramp_steps=4,
                             max_mined_frac=0.5),
        mine_queries=64, refresh_every=10)
    j_router = JaxRouter(x, k_top=10)
    j_router.add_tenant("prod", np.eye(8, dtype=np.float32))
    p_router = TenantRouter(x, k_top=10, device=CPU)
    p_router.add_tenant("prod", np.eye(8, dtype=np.float32))
    jt = JaxLoop(jcfg, x, y, router=j_router, tenant="prod",
                 shadow_probe=4)
    Lj, hj = jt.run()
    pt = ClosedLoopTrainer(closed_loop_config_from_jax(jcfg), x, y,
                           L0=np.asarray(jt.L0), router=p_router,
                           tenant="prod", shadow_probe=4, device=CPU)
    Lp, hp = pt.run()
    _assert_same_runs(jt, hj, Lj, pt, hp, Lp)
    for rp, rj in zip(hp["refreshes"][1:], hj["refreshes"][1:]):
        assert rp["shadow"]["n_mirrored"] == rj["shadow"]["n_mirrored"] == 4
        assert rp["shadow"]["overlap_at_k"] == rj["shadow"]["overlap_at_k"]
        assert rp["promoted_tenant"] == "prod"
    np.testing.assert_allclose(p_router.tenant("prod").L,
                               j_router.tenant("prod").L, **TOL)
    assert p_router.observability()["tenants"]["prod"]["n_requests"] == \
        j_router.observability()["tenants"]["prod"]["n_requests"]


def test_config_carries_every_field():
    jcfg = JaxLoopConfig(
        train=JaxTrainConfig(
            dml=jax_dml.DMLConfig(feat_dim=12, l_rank=5, lam=0.5,
                                  margin=2.0, compute_dtype=jnp.bfloat16),
            ps=jax_sync.PSConfig(n_workers=3, sync="ssp", staleness=2,
                                 seed=4),
            batch_size=32, steps=7, lr=0.5, log_every=3),
        miner=JaxMinerConfig(k_neighbors=7, margin=0.5, semi_hard=False,
                             fallback_nearest=False, band_pct=40.0,
                             max_negatives=3, max_positives=0,
                             pos_candidates=5),
        schedule=JaxSchedule(warmup_steps=1, ramp_steps=2,
                             max_mined_frac=0.25),
        index="ivf", index_kwargs=dict(n_clusters=4, nprobe=2),
        refresh_every=0, plateau_window=4, plateau_tol=0.1,
        min_refresh_gap=3, mine_queries=9)
    cfg = closed_loop_config_from_jax(jcfg)
    d = cfg.train.dml
    assert (d.feat_dim, d.proj_dim, d.l_rank, d.lam, d.margin) == \
        (12, 5, 5, 0.5, 2.0)
    assert d.dtype == torch.float32 and d.compute_dtype == torch.bfloat16
    assert cfg.train.ps == sync.PSConfig(n_workers=3, sync="ssp",
                                         staleness=2, seed=4)
    assert (cfg.train.batch_size, cfg.train.steps, cfg.train.lr,
            cfg.train.log_every) == (32, 7, 0.5, 3)
    assert cfg.miner == MinerConfig(k_neighbors=7, margin=0.5,
                                    semi_hard=False, fallback_nearest=False,
                                    band_pct=40.0, max_negatives=3,
                                    max_positives=0, pos_candidates=5)
    assert cfg.schedule == CurriculumSchedule(1, 2, 0.25)
    assert (cfg.index, cfg.index_kwargs, cfg.refresh_every,
            cfg.plateau_window, cfg.plateau_tol, cfg.min_refresh_gap,
            cfg.mine_queries) == ("ivf", dict(n_clusters=4, nprobe=2), 0,
                                  4, 0.1, 3, 9)


# -- the reference's TestClosedLoop on the port -------------------------------

def _cfg(d=16, steps=30, **kw):
    return ClosedLoopConfig(
        train=DMLTrainConfig(dml=dml.DMLConfig(feat_dim=d, proj_dim=8),
                             ps=sync.PSConfig(n_workers=1),
                             batch_size=64, steps=steps, lr=1e-2,
                             log_every=10),
        miner=MinerConfig(k_neighbors=10),
        schedule=CurriculumSchedule(warmup_steps=4, ramp_steps=8,
                                    max_mined_frac=0.5),
        mine_queries=128, **kw)


def test_refresh_bumps_version_and_flushes_cache():
    x, y = _blobs(n=400)
    clt = ClosedLoopTrainer(_cfg(refresh_every=10), x, y, device=CPU)
    eng = clt.engine
    q = x[:4]
    eng.search(q)
    eng.search(q)                   # second hit comes from the LRU
    assert eng.cache_hits > 0 and len(eng._cache) > 0
    v0 = eng.index.version
    clt.refresh(0.1 * np.ones((8, 16), np.float32), step=0)
    assert eng.index.version == v0 + 1
    hits0 = eng.cache_hits
    eng.search(q)                   # lazy flush fires here
    assert eng.cache_hits == hits0
    assert clt.source.pool_size > 0


def test_frozen_base_refresh_rebuilds():
    x, y = _blobs(n=300)
    clt = ClosedLoopTrainer(_cfg(index="exact", refresh_every=10), x, y,
                            device=CPU)
    idx0 = clt.engine.index
    L_new = 0.1 * np.ones((8, 16), np.float32)
    clt.refresh(L_new, step=0)
    assert clt.engine.index is not idx0
    assert isinstance(clt.engine.index, ExactIndex)
    assert torch.equal(clt.engine.index.gp,
                       ExactIndex.build(L_new, x, device=CPU).gp)
    assert "rebuild" in clt.timings[-1]


def test_mutable_ivf_loop_runs():
    x, y = _blobs(n=512, c=4)
    cfg = _cfg(steps=20, index="mutable-ivf",
               index_kwargs=dict(n_clusters=8, nprobe=8), refresh_every=8)
    clt = ClosedLoopTrainer(cfg, x, y, device=CPU)
    L, hist = clt.run()
    assert hist["summary"]["n_refreshes"] >= 2
    assert isinstance(clt.engine.index, MutableIndex)
    assert clt.engine.index.n_swaps >= 1
    assert np.isfinite(hist["steps"][-1]["loss"])


def test_plateau_policy_triggers():
    x, y = _blobs(n=300)
    cfg = _cfg(steps=40, refresh_every=0, plateau_window=6,
               plateau_tol=0.5, min_refresh_gap=5)
    _, hist = ClosedLoopTrainer(cfg, x, y, device=CPU).run()
    assert hist["summary"]["n_refreshes"] >= 2


def test_history_records_staleness():
    x, y = _blobs(n=300)
    _, hist = ClosedLoopTrainer(_cfg(refresh_every=10), x, y,
                                device=CPU).run()
    stal = [h["staleness"] for h in hist["steps"]]
    assert max(stal) < 10
    assert "mean_staleness" in hist["summary"]
    assert hist["summary"]["total_mined_pairs"] > 0


def test_no_policy_rejected():
    with pytest.raises(ValueError, match="staleness policy"):
        _cfg(refresh_every=0, plateau_window=0)
    with pytest.raises(ValueError, match="index kind"):
        _cfg(index="ivfpq", refresh_every=5)
    with pytest.raises(ValueError, match="mine_queries"):
        ClosedLoopConfig(train=_cfg(refresh_every=5).train, mine_queries=0)


def test_step_hook_gets_the_merged_factor_and_registry_gauges():
    x, y = _blobs(n=300)
    seen = []

    def hook(t, L):
        assert torch.is_tensor(L) and L.shape == (8, 16)
        seen.append(t)
        return t * 2

    clt = ClosedLoopTrainer(_cfg(refresh_every=10), x, y, device=CPU)
    _, hist = clt.run(step_hook=hook)
    assert seen == [0, 10, 20, 29]
    assert [h["hook"] for h in hist["steps"]] == [0, 20, 40, 58]
    r = clt.registry
    assert r.counter("loop_refreshes_total").value() == 3
    assert r.gauge("loop_pool_size").value() == clt.source.pool_size
    assert r.gauge("loop_staleness_steps").value() == 9
    assert [e["refresh"] for e in r.events("loop_refresh")] == [1, 2, 3]
    traces = clt.tracer.drain()
    assert [t["root"]["name"] for t in traces] == ["refresh"] * 3
    assert [c["name"] for c in traces[0]["root"]["children"]] == ["mine"]
    assert [c["name"] for c in traces[-1]["root"]["children"]] == \
        ["swap_metric", "mine"]


# -- the reference's TestClosedLoopRouter on the port -------------------------

def _router_cfg(d=8, **kw):
    return ClosedLoopConfig(
        train=DMLTrainConfig(dml=dml.DMLConfig(feat_dim=d, proj_dim=4),
                             ps=sync.PSConfig(n_workers=1),
                             batch_size=64, steps=10, lr=1e-2,
                             log_every=10),
        miner=MinerConfig(k_neighbors=10),
        schedule=CurriculumSchedule(warmup_steps=2, ramp_steps=4,
                                    max_mined_frac=0.5),
        mine_queries=64, refresh_every=10, **kw)


def test_refresh_promotes_through_shadow():
    """The promoted view is bit-identical to a fresh build under the new
    L, and the live tenant answers under it."""
    x, y = _blobs(n=200, d=8, c=4)
    router = TenantRouter(x, k_top=10, device=CPU)
    router.add_tenant("prod", np.eye(8, dtype=np.float32))
    router.search("prod", x[0])
    fp0 = router.tenant("prod").fingerprint
    clt = ClosedLoopTrainer(_router_cfg(), x, y, router=router,
                            tenant="prod", shadow_probe=4, device=CPU)
    L_new = (0.1 * np.random.RandomState(3).randn(4, 8)).astype(np.float32)
    rec = clt.refresh(torch.from_numpy(L_new), step=10)
    assert rec["promoted_tenant"] == "prod"
    assert rec["shadow"]["n_mirrored"] == 4
    t = router.tenant("prod")
    assert t.fingerprint != fp0 and t.shadow is None
    np.testing.assert_array_equal(t.L, L_new)
    fresh = ExactIndex.build(L_new, x, device=CPU)
    view = t.engine.index
    assert torch.equal(view.gp, fresh.gp) and torch.equal(view.gn, fresh.gn)
    _, ids = router.search("prod", x[:3])
    _, o_ids = RetrievalEngine(fresh, k_top=10).search(x[:3])
    np.testing.assert_array_equal(ids, o_ids)
    assert "promote" in clt.timings[-1]


def test_router_validation():
    x, y = _blobs(n=120, d=8, c=4)
    router = TenantRouter(x, device=CPU)
    router.add_tenant("prod", np.eye(8, dtype=np.float32))
    with pytest.raises(ValueError, match="together"):
        ClosedLoopTrainer(_router_cfg(), x, y, router=router, device=CPU)
    with pytest.raises(Exception, match="unknown tenant"):
        ClosedLoopTrainer(_router_cfg(), x, y, router=router,
                          tenant="nope", device=CPU)
    wrong = TenantRouter(np.zeros((50, 6), np.float32), device=CPU)
    wrong.add_tenant("prod", np.eye(6, dtype=np.float32))
    with pytest.raises(ValueError, match="d_in"):
        ClosedLoopTrainer(_router_cfg(), x, y, router=wrong,
                          tenant="prod", device=CPU)


# -- the reference's TestConvergenceSmoke on the port -------------------------

def test_mined_not_worse_than_uniform_tiny():
    cfg = pairdata.PairDatasetConfig(
        n_samples=2000, feat_dim=48, n_classes=32, kind="noisy_subspace",
        noise=0.3, seed=0)
    x, y = pairdata.make_features(cfg)
    tr_x, tr_y, te_x, te_y = x[:1600], y[:1600], x[1600:], y[1600:]
    tcfg = DMLTrainConfig(dml=dml.DMLConfig(feat_dim=48, proj_dim=12),
                          ps=sync.PSConfig(n_workers=1), batch_size=128,
                          steps=60, lr=3e-3, log_every=20)
    idx = pairdata.sample_pair_indices(tr_y, 8000, 8000, seed=1)
    uni = {"xs": tr_x[idx["a"]], "ys": tr_x[idx["b"]], "sim": idx["sim"]}
    L_u, _ = train_dml_distributed(tcfg, uni, device=CPU)
    ccfg = ClosedLoopConfig(
        train=tcfg,
        miner=MinerConfig(k_neighbors=15, max_negatives=1, max_positives=3),
        schedule=CurriculumSchedule(warmup_steps=5, ramp_steps=10,
                                    max_mined_frac=0.7),
        refresh_every=10, mine_queries=1600)
    L_m, hist = ClosedLoopTrainer(ccfg, tr_x, tr_y, device=CPU).run()
    acc_u = eval_tasks.knn_accuracy(L_u, tr_x, tr_y, te_x, te_y, k=5,
                                    device=CPU)
    acc_m = eval_tasks.knn_accuracy(L_m, tr_x, tr_y, te_x, te_y, k=5,
                                    device=CPU)
    assert hist["summary"]["n_refreshes"] >= 4
    assert acc_m >= acc_u - 0.02, (acc_m, acc_u)


# -- the command lines --------------------------------------------------------

def _run(module, *argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


@pytest.mark.parametrize("index", ["mutable-exact", "mutable-ivf", "exact",
                                   "ivf"])
def test_train_mined_cli(index):
    out = _run("repro_torch.launch.train_mined", "--device", "cpu",
               "--index", index, "--n-samples", "800", "--feat-dim", "16",
               "--n-classes", "8", "--steps", "20", "--eval-every", "10",
               "--refresh-every", "8", "--mine-queries", "200",
               "--n-clusters", "8", "--nprobe", "4", "--baseline")
    assert f"closed loop: {index} index over 640 rows on cpu" in out
    assert "step,loss,knn_acc,staleness,mined_frac" in out
    assert "3 refreshes" in out and "cpu path" in out
    assert "final kNN accuracy (mined, 20 steps)" in out
    assert "final kNN accuracy (uniform, 20 steps)" in out


def _render_both(path):
    with open(path) as f:
        snap = json.load(f)
    return metrics_report.render(snap), jax_report.render(snap)


@pytest.mark.parametrize("scheduler", [False, True])
def test_serve_retrieval_mine_and_metrics_out(tmp_path, scheduler):
    path = tmp_path / "metrics.json"
    out = _run("repro_torch.launch.serve_retrieval", "--device", "cpu",
               "--gallery-size", "800", "--train-steps", "0",
               "--requests", "60", "--mine", "64", "--metrics-out",
               str(path), *(["--scheduler"] if scheduler else []))
    via = "scheduler mining class" if scheduler else "direct engine path"
    assert f"mining ({via}):" in out and "from 64 anchors" in out
    assert "0 shed by the front end" in out
    assert f"metrics snapshot -> {path}" in out
    ours, ref = _render_both(path)
    assert ours == ref and "== serving ==" in ours
    assert ("== front end ==" in ours) == scheduler
    counters = json.loads(path.read_text())["counters"]
    assert counters["miner_queries_total"]["values"][""] == 64
    # the reporter's own command line, with --merge
    text = _run("repro_torch.launch.metrics_report", str(path), "--merge",
                str(path), "--events", "3")
    assert "== serving ==" in text


def test_metrics_report_renders_a_loop_snapshot_as_the_reference(tmp_path):
    x, y = _blobs(n=300)
    clt = ClosedLoopTrainer(_cfg(refresh_every=10, steps=12), x, y,
                            device=CPU)
    clt.run()
    path = tmp_path / "loop.json"
    clt.engine.registry.write_snapshot(str(path))
    ours, ref = _render_both(path)
    assert ours == ref
    assert "== closed loop ==" in ours and "refreshes: 2" in ours
    assert "mined pairs: fallback_neg=" in ours
