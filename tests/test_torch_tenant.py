"""The port's multi-tenant router, on the CPU: the reference's cases
(tests/test_tenant.py) on ``repro_torch.serve.TenantRouter`` with
``device="cpu"`` at the same sizes (M 120 rows, d_in 8, seeded), then
both packages' routers started from one state through
``convert.tenant_router_from_jax`` (the same answers on every tenant:
ids equal, distances within atol + rtol * (||qp||² + ||gp||²), rtol =
atol = 1e-5, the repo's rule for the factored distance), and each
package loading the other's ``save_tenants`` output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve import TenantRouter as JaxTenantRouter
from repro.serve import load_tenants as jax_load_tenants
from repro.serve import save_tenants as jax_save_tenants

from repro_torch.convert import tenant_router_from_jax
from repro_torch.serve import (ExactIndex, RequestScheduler,
                               RetrievalEngine, TenantError,
                               TenantFingerprintError, TenantRouter,
                               attach_view, load_tenants, save_tenants)
from repro_torch.serve import tenant as tenant_mod

M, D = 120, 8
K = 5
CPU = "cpu"


@pytest.fixture
def feats():
    rng = np.random.RandomState(0)
    return rng.randn(M, D).astype(np.float32)


def _L(seed, d_out=4):
    return (0.3 * np.random.RandomState(seed)
            .randn(d_out, D)).astype(np.float32)


def _router(feats, **kw):
    kw.setdefault("k_top", K)
    kw.setdefault("device", CPU)
    return TenantRouter(feats, **kw)


def _oracle(L, feats, q, k=K):
    """Exact top-k over ALL rows under metric L, as (dists, ids)."""
    eng = RetrievalEngine(ExactIndex.build(L, feats, device=CPU), k_top=k)
    return eng.search(q)


IVF_KW = dict(n_clusters=4, nprobe=4)
# every probed row reranked exactly: IVFPQ answers equal the exact scan
IVFPQ_KW = dict(n_clusters=4, nprobe=4, n_subspaces=2, bits=4,
                rerank_depth=1000)


class TestServing:
    @pytest.mark.parametrize("backend,kw", [
        ("exact", {}), ("ivf", IVF_KW), ("ivfpq", IVFPQ_KW)])
    def test_search_matches_exact_oracle(self, feats, backend, kw):
        router = _router(feats)
        router.add_tenant("a", _L(1), backend=backend, build_kwargs=kw)
        q = feats[3] + 0.01
        dists, ids = router.search("a", q)
        o_dists, o_ids = _oracle(_L(1), feats, q)
        np.testing.assert_array_equal(ids, o_ids)
        np.testing.assert_allclose(dists, o_dists, rtol=1e-5)

    def test_lazy_warm_and_idempotence(self, feats):
        router = _router(feats)
        t = router.add_tenant("a", _L(1))
        assert not t.warm and t.engine is None
        router.search("a", feats[0])
        assert t.warm
        eng = t.engine
        router.warm("a")
        assert t.engine is eng
        assert router.observability()["tenants"]["a"]["warm"]

    def test_per_tenant_caches_never_collide(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        router.add_tenant("b", _L(2))
        q = feats[7] + 0.02
        _, ids_a = router.search("a", q)
        _, ids_b = router.search("b", q)
        assert not np.array_equal(ids_a, ids_b)
        _, ids_a2 = router.search("a", q)
        _, ids_b2 = router.search("b", q)
        np.testing.assert_array_equal(ids_a, ids_a2)
        np.testing.assert_array_equal(ids_b, ids_b2)
        for name in ("a", "b"):
            st = router.tenant(name).engine.stats()
            assert st["cache_hits"] == 1 and st["cache_misses"] == 1

    def test_submit_via_scheduler_equals_direct_search(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1), deadline_s=30.0)
        router.add_tenant("b", _L(2), backend="ivf", build_kwargs=IVF_KW,
                          deadline_s=30.0)
        sched = RequestScheduler(router.warm("a").engine,
                                 registry=router.registry,
                                 max_wait_ms=0.0, degrade=False)
        router.attach_scheduler(sched)
        try:
            qs = feats[:6] + 0.01
            futs = [(name, i, router.submit(name, qs[i]))
                    for i, name in enumerate(["a", "b", "a", "b", "a",
                                              "b"])]
            for name, i, fut in futs:
                dists, ids = fut.result(timeout=30)
                o_dists, o_ids = router.search(name, qs[i])
                np.testing.assert_array_equal(ids, o_ids)
                np.testing.assert_allclose(dists, o_dists, rtol=1e-5)
            assert set(sched.routes()) == {"a", "b"}
        finally:
            sched.close()

    def test_submit_without_scheduler_raises(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        with pytest.raises(TenantError, match="scheduler"):
            router.submit("a", feats[0])


class TestGalleryMutation:
    def test_extend_gives_stable_ids_and_staleness(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        router.warm("a")
        gen0 = router.generation
        new = np.full((3, D), 9.0, np.float32)
        new_ids = router.extend(new)
        np.testing.assert_array_equal(new_ids, [M, M + 1, M + 2])
        assert router.generation == gen0 + 1
        assert router.observability()["tenants"]["a"]["stale"]
        _, ids = router.search("a", new[0])
        assert set(new_ids.tolist()) <= set(ids.tolist())

    def test_remove_tombstones_and_ids_survive(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        q = feats[3] + 0.001
        _, ids = router.search("a", q)
        victim = int(ids[0])
        assert router.remove([victim]) == 1
        assert router.remove([victim]) == 0
        _, ids2 = router.search("a", q)
        assert victim not in ids2.tolist()
        assert set(ids2.tolist()) <= set(range(M)) - {victim}
        with pytest.raises(TenantError, match="out of range"):
            router.remove([M + 50])

    def test_store_grows_by_blocks_without_copying(self, feats):
        """``extend`` appends a block and leaves the stored ones where
        they are; the new rows are copied, so the store never changes
        under a caller's array or tensor."""
        router = _router(feats)
        first = router._blocks[0]
        rows = torch.randn(7, D)
        ids = router.extend(rows)
        assert router._blocks[0] is first
        assert router._blocks[1].data_ptr() != rows.data_ptr()
        np.testing.assert_array_equal(ids, np.arange(M, M + 7))
        np.testing.assert_array_equal(router.rows()[M:], rows.numpy())
        feats[0] = 100.0                    # the caller's array, not ours
        rows[0] = 100.0
        assert float(router._blocks[0][0, 0]) != 100.0
        assert float(router._blocks[1][0, 0]) != 100.0
        with pytest.raises(TenantError, match="rows must be"):
            router.extend(np.zeros((2, D + 1), np.float32))

    def test_view_projects_live_rows_in_blocks(self, feats, monkeypatch):
        """The view build projects VIEW_BLOCK store rows a step, skipping
        dead rows (and wholly dead blocks), across store blocks: the same
        view as one projection of the live rows."""
        monkeypatch.setattr(tenant_mod, "VIEW_BLOCK", 16)
        router = _router(feats)
        router.extend(np.random.RandomState(2).randn(40, D)
                      .astype(np.float32))
        router.remove(np.r_[np.arange(16, 32), [3, 130, 159]])
        router.add_tenant("a", _L(1))
        t = router.warm("a")
        live = np.flatnonzero(~router._dead)
        np.testing.assert_array_equal(t.ids, live)
        want = torch.from_numpy(router.rows()[live]) @ torch.from_numpy(
            _L(1)).T
        torch.testing.assert_close(t.engine.index.gp, want, rtol=1e-6,
                                   atol=1e-6)
        q = feats[40] + 0.01
        _, ids = router.search("a", q)
        assert set(ids.tolist()) <= set(live.tolist())


class TestShadow:
    def test_deterministic_sampling_and_overlap(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        arm = router.register_shadow("a", _L(1), sample_rate=0.5)
        for i in range(8):
            router.search("a", feats[i] + 0.01)
        assert arm.n_mirrored == 4
        assert arm.stats()["overlap_at_k"] == 1.0
        snap = router.registry.snapshot()
        mirrored = snap["counters"]["shadow_mirrored_total"]["values"]
        assert mirrored == {"tenant=a": 4.0}

    @pytest.mark.parametrize("backend,kw", [("ivf", IVF_KW),
                                            ("ivfpq", IVFPQ_KW)])
    def test_promote_is_bit_identical_to_fresh_build(self, feats, backend,
                                                     kw):
        router = _router(feats)
        router.add_tenant("a", _L(1), backend=backend, build_kwargs=kw)
        router.search("a", feats[0])
        L_cand = _L(9)
        router.register_shadow("a", L_cand, sample_rate=1.0)
        router.search("a", feats[1])
        t = router.promote("a")
        assert t.shadow is None
        assert t.fingerprint != _router(feats).add_tenant(
            "x", _L(1)).fingerprint
        fresh = _router(feats)
        fresh.add_tenant("f", L_cand, backend=backend, build_kwargs=kw)
        probe = feats[:16] + 0.01
        d_live, i_live = router.search("a", probe)
        d_fresh, i_fresh = fresh.search("f", probe)
        np.testing.assert_array_equal(i_live, i_fresh)
        np.testing.assert_array_equal(d_live, d_fresh)

    def test_promote_cold_tenant_and_errors(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        with pytest.raises(TenantError, match="no shadow"):
            router.promote("a")
        router.register_shadow("a", _L(9))
        t = router.promote("a")
        assert t.warm and t.shadow is None
        _, ids = router.search("a", feats[0])
        _, o_ids = _oracle(_L(9), feats, feats[0])
        np.testing.assert_array_equal(ids, o_ids)
        with pytest.raises(TenantError, match="sample_rate"):
            router.register_shadow("a", _L(9), sample_rate=0.0)


class TestSnapshots:
    def test_multi_tenant_round_trip(self, feats, tmp_path):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        router.add_tenant("b", _L(2), backend="ivf", build_kwargs=IVF_KW)
        router.add_tenant("c", _L(4), backend="ivfpq",
                          build_kwargs=IVFPQ_KW)
        router.add_tenant("cold", _L(3))
        for name in ("a", "b", "c"):
            router.warm(name)
        save_tenants(router, str(tmp_path))

        back = load_tenants(str(tmp_path), device=CPU)
        assert set(back.tenants()) == {"a", "b", "c", "cold"}
        assert all(back.tenant(n).warm for n in ("a", "b", "c"))
        assert not back.tenant("cold").warm
        q = feats[5] + 0.01
        for name in ("a", "b", "c", "cold"):
            d0, i0 = router.search(name, q)
            d1, i1 = back.search(name, q)
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(d0, d1)

    def test_stale_views_persist_as_cold(self, feats, tmp_path):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        router.warm("a")
        router.extend(np.ones((2, D), np.float32))
        save_tenants(router, str(tmp_path))
        back = load_tenants(str(tmp_path), device=CPU)
        assert not back.tenant("a").warm
        assert back.gallery_rows == M + 2

    def test_attach_fingerprint_mismatch_rejected(self, feats, tmp_path):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        router.warm("a")
        save_tenants(router, str(tmp_path))
        other = _router(feats)
        other.add_tenant("a", _L(2))
        with pytest.raises(TenantFingerprintError):
            attach_view(other, "a", str(tmp_path / "tenant_a"))
        assert not other.tenant("a").warm

    def test_load_with_swapped_factors_typed_error(self, feats, tmp_path):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        save_tenants(router, str(tmp_path))
        np.savez(str(tmp_path / "factors.npz"), a=_L(2))
        with pytest.raises(TenantFingerprintError,
                           match="different saves"):
            load_tenants(str(tmp_path), device=CPU)


class TestAccountingAndObs:
    def test_memory_counts_gallery_once(self, feats):
        router = _router(feats)
        for i, name in enumerate(("a", "b", "c")):
            router.add_tenant(name, _L(i + 1))
            router.warm(name)
        mem = router.memory()
        assert mem["gallery"] == feats.nbytes + M    # rows + dead mask
        assert set(mem["tenants"]) == {"a", "b", "c"}
        assert mem["total"] == (mem["gallery"]
                                + sum(mem["tenants"].values()))
        independent = sum(mem["gallery"] + v
                          for v in mem["tenants"].values())
        assert mem["total"] < independent
        router.extend(np.ones((4, D), np.float32))
        assert router.memory()["gallery"] == (M + 4) * (D * 4 + 1)

    def test_engine_series_carry_tenant_labels(self, feats):
        router = _router(feats)
        router.add_tenant("a", _L(1))
        router.add_tenant("b", _L(2))
        router.search("a", feats[0])
        router.search("b", feats[0])
        snap = router.registry.snapshot()
        reqs = snap["counters"]["engine_requests_total"]["values"]
        assert set(reqs) == {"tenant=a", "tenant=b"}
        assert snap["counters"]["tenant_requests_total"]["values"] == {
            "tenant=a": 1.0, "tenant=b": 1.0}

    def test_validation_errors(self, feats):
        router = _router(feats)
        with pytest.raises(TenantError, match="invalid tenant name"):
            router.add_tenant("bad#name", _L(1))
        with pytest.raises(TenantError, match="unknown backend"):
            router.add_tenant("a", _L(1), backend="faiss")
        with pytest.raises(TenantError, match="L must be"):
            router.add_tenant("a", np.zeros((4, D + 1), np.float32))
        router.add_tenant("a", _L(1))
        with pytest.raises(TenantError, match="already registered"):
            router.add_tenant("a", _L(2))
        with pytest.raises(TenantError, match="unknown tenant"):
            router.tenant("zzz")
        with pytest.raises(TenantError, match="gallery must be"):
            TenantRouter(np.zeros((M,), np.float32), device=CPU)

    def test_store_is_copied_unless_asked(self, feats):
        """The default router copies the gallery, so a later write by the
        caller leaves every view as it was; copy=False shares a float32
        tensor's memory and takes nothing else."""
        g = torch.from_numpy(feats.copy())
        q = feats[:3] + 0.05
        copied = _router(g)
        copied.add_tenant("a", _L(1))
        before = copied.search("a", q)
        shared = _router(g, copy=False)
        assert shared._blocks[0].data_ptr() == g.data_ptr()
        g.mul_(-1.0)
        after = copied.search("a", q)
        np.testing.assert_array_equal(after[1], before[1])
        np.testing.assert_array_equal(after[0], before[0])
        assert torch.equal(shared._blocks[0], g)
        for bad in (feats, g.double(), g.t()):
            with pytest.raises(TenantError, match="copy=False"):
                _router(bad, copy=False)


# -- parity with the reference router -----------------------------------------

PARITY_TENANTS = {"a": ("exact", {}, 1), "b": ("ivf", IVF_KW, 2),
                  "c": ("ivfpq", IVFPQ_KW, 3)}


def _jax_router(feats):
    """A reference router with three tenants, its store extended and a few
    rows removed (dead mask and generation past their start)."""
    router = JaxTenantRouter(feats, k_top=K)
    for name, (backend, kw, seed) in PARITY_TENANTS.items():
        router.add_tenant(name, _L(seed), backend=backend, build_kwargs=kw,
                          deadline_s=2.0)
    router.extend(np.random.RandomState(5).randn(9, D).astype(np.float32))
    router.remove([2, 17, 121])
    return router


def _state(router):
    """A reference router's state in ``tenant_router_from_jax``'s form."""
    return {"rows": router._rows, "dead": router._dead,
            "generation": router.generation, "k_top": router.k_top,
            "tenants": {n: {"L": t.L, "backend": t.backend,
                            "build_kwargs": t.build_kwargs,
                            "k_top": t.k_top, "cache_size": t.cache_size,
                            "priority": t.priority,
                            "deadline_s": t.deadline_s}
                        for n, t in router._tenants.items()}}


def _assert_same_answers(name, L, rows, q, got, ref):
    """ids equal; distances within the factored-distance rule."""
    (d, i), (d_ref, i_ref) = got, ref
    np.testing.assert_array_equal(i, i_ref)
    gp = rows.astype(np.float64) @ L.T
    qp = np.atleast_2d(q).astype(np.float64) @ L.T
    tol = 1e-5 + 1e-5 * (np.sum(qp * qp, 1)[:, None]
                         + np.sum(gp * gp, 1)[np.atleast_2d(i_ref)])
    err = np.abs(np.atleast_2d(d) - np.atleast_2d(d_ref))
    assert (err <= tol).all(), f"{name}: max err {err.max():.3e}"


def test_router_from_jax_serves_as_the_reference(feats):
    jr = _jax_router(feats)
    pr = tenant_router_from_jax(_state(jr), device=CPU)
    assert (pr.gallery_rows, pr.live_rows, pr.generation, pr.tenants()) \
        == (jr.gallery_rows, jr.live_rows, jr.generation, jr.tenants())
    for name in jr.tenants():
        jt, pt = jr.tenant(name), pr.tenant(name)
        assert pt.fingerprint == jt.fingerprint
        assert (pt.backend, pt.build_kwargs, pt.k_top, pt.priority,
                pt.deadline_s) == (jt.backend, jt.build_kwargs, jt.k_top,
                                   jt.priority, jt.deadline_s)
    q = np.concatenate([feats[:6], jr._rows[-3:]]) + 0.01
    for name, (_, _, seed) in PARITY_TENANTS.items():
        got = pr.search(name, q)
        _assert_same_answers(name, _L(seed), jr._rows, q, got,
                             jr.search(name, jnp.asarray(q)))
        assert not set(got[1].ravel().tolist()) & {2, 17, 121}
    # one more mutation on both: the lazy rebuilds agree too
    for r in (jr, pr):
        r.remove([0, 1])
    for name, (_, _, seed) in PARITY_TENANTS.items():
        _assert_same_answers(name, _L(seed), jr._rows, q,
                             pr.search(name, q), jr.search(name, q))


def test_port_loads_reference_tenant_snapshot(feats, tmp_path):
    jr = _jax_router(feats)
    for name in ("a", "b"):
        jr.warm(name)
    jax_save_tenants(jr, str(tmp_path))
    back = load_tenants(str(tmp_path), device=CPU)
    assert back.tenant("a").warm and back.tenant("b").warm
    assert not back.tenant("c").warm
    assert back.generation == jr.generation
    np.testing.assert_array_equal(back.tenant("b").ids, jr.tenant("b").ids)
    q = feats[10:14] + 0.01
    for name, (_, _, seed) in PARITY_TENANTS.items():
        _assert_same_answers(name, _L(seed), jr._rows, q,
                             back.search(name, q), jr.search(name, q))


def test_reference_loads_port_tenant_snapshot(feats, tmp_path):
    pr = tenant_router_from_jax(_state(_jax_router(feats)), device=CPU)
    for name in ("a", "b", "c"):
        pr.warm(name)
    save_tenants(pr, str(tmp_path))
    back = jax_load_tenants(str(tmp_path))
    assert all(back.tenant(n).warm for n in ("a", "b", "c"))
    np.testing.assert_array_equal(np.asarray(back._dead), pr._dead)
    q = feats[20:24] + 0.01
    rows = pr.rows()
    for name, (_, _, seed) in PARITY_TENANTS.items():
        _assert_same_answers(name, _L(seed), rows, q,
                             back.search(name, q), pr.search(name, q))


# -- the launcher -------------------------------------------------------------

def test_cli_scheduler_tenants_and_shadow_on_cpu():
    """``python -m repro_torch.launch.serve_retrieval --device cpu --index
    ivf --scheduler --tenants 2 --shadow`` at a small size prints the
    ladder, the per-class outcomes and the tenant block."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_retrieval",
         "--device", "cpu", "--index", "ivf", "--scheduler", "--tenants",
         "2", "--shadow", "--gallery-size", "1200", "--train-steps", "0",
         "--requests", "120", "--n-clusters", "16", "--nprobe", "8"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout
    assert ("scheduler ladder: [{}, {'nprobe': 4}, {'nprobe': 2}]"
            in out)
    for cls in ("interactive", "batch", "mining"):
        assert f"class {cls}: admitted" in out
    assert "degradation: level" in out
    assert "tenants: 2 metrics over one 1200-row gallery on cpu" in out
    assert "t0: backend=ivf" in out and "t1: backend=ivf" in out
    assert "shadow@t1: mirrored 16 (rate 0.5)" in out
    assert "promoted shadow -> t1 live" in out


def test_cli_rejects_shadow_without_two_tenants():
    from repro_torch.launch import serve_retrieval
    for extra in ([], ["--tenants", "1"]):
        with pytest.raises(SystemExit):
            serve_retrieval.main(["--device", "cpu", "--shadow",
                                  "--train-steps", "0", *extra])
