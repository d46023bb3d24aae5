"""The port's slices end to end, port against reference, on the CPU.

The same seeded data goes through both packages: ``make_features`` must
be byte-identical, the factor and the reference's index arrays are
carried across with repro_torch.convert, and the same request stream
must come back with the same neighbours. The training pipeline
(``train_eval_split -> train_dml_single -> ExactIndex``) starts from the
reference's initial factor and must serve the same neighbours as the
reference's pipeline. The port's CLI trains and serves on the CPU, and
takes the reference's ``--trace-sample`` / ``--trace-out`` and
``--backend`` flags with the reference's checks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import dml_paper as jax_configs
from repro.core import dml as jax_dml
from repro.core.ps.trainer import train_dml_single as jax_train_dml_single
from repro.data import pairs as jax_pairs
from repro.serve import ExactIndex as JaxExactIndex
from repro.serve import RetrievalEngine as JaxRetrievalEngine

from repro_torch.configs import dml_paper
from repro_torch.convert import exact_index_from_jax, metric_factor_from_jax
from repro_torch.core import dml
from repro_torch.core.ps.trainer import train_dml_single
from repro_torch.data import pairs
from repro_torch.launch import serve_retrieval
from repro_torch.obs.trace import span_names
from repro_torch.serve import ExactIndex, RetrievalEngine


@pytest.mark.parametrize("kind", ["class_blobs", "mnist_like",
                                  "noisy_subspace", "llc_like"])
def test_make_features_byte_identical(kind):
    kw = dict(n_samples=300, feat_dim=40, n_classes=7, kind=kind, seed=3)
    x, y = pairs.make_features(pairs.PairDatasetConfig(**kw))
    xr, yr = jax_pairs.make_features(jax_pairs.PairDatasetConfig(**kw))
    assert x.dtype == xr.dtype and y.dtype == yr.dtype
    assert x.tobytes() == xr.tobytes() and y.tobytes() == yr.tobytes()


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown kind"):
        pairs.make_features(pairs.PairDatasetConfig(10, 4, 2, kind="nope"))


def test_configs_match_reference():
    for exp in (dml_paper.MNIST, dml_paper.IMNET_63K, dml_paper.IMNET_1M):
        ref = jax_configs.EXPERIMENTS[exp.name]
        for f in dataclasses.fields(exp):
            if f.name != "dml":
                assert getattr(exp, f.name) == getattr(ref, f.name)
        assert (exp.dml.feat_dim, exp.dml.proj_dim) == \
            (ref.dml.feat_dim, ref.dml.proj_dim)
    small = dml_paper.scaled_down(dml_paper.IMNET_1M)
    small_ref = jax_configs.scaled_down(jax_configs.IMNET_1M)
    assert (small.name, small.n_samples, small.dml.proj_dim) == \
        (small_ref.name, small_ref.n_samples, small_ref.dml.proj_dim)


@pytest.mark.parametrize("kw", [dict(feat_dim=8, proj_dim=4, l_rank=3),
                                dict(feat_dim=8, l_rank=9)])
def test_dml_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ours:
        dml.DMLConfig(**kw)
    with pytest.raises(ValueError) as ref:
        jax_dml.DMLConfig(**kw)
    assert str(ours.value) == str(ref.value)


def test_init_params_shape_and_scale():
    cfg = dml.DMLConfig(feat_dim=400, l_rank=30)
    assert cfg.proj_dim == 30
    L = dml.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    L_ref = jax_dml.init_params(jax_dml.DMLConfig(feat_dim=400, l_rank=30),
                                jax.random.PRNGKey(0))
    assert tuple(L.shape) == tuple(L_ref.shape) and L.dtype == torch.float32
    assert abs(float(L.std()) - float(np.std(L_ref))) < 0.1 / np.sqrt(400)


def test_convert_carries_factor_and_index_exactly():
    x, _ = jax_pairs.make_features(jax_pairs.PairDatasetConfig(
        n_samples=200, feat_dim=24, n_classes=4, seed=0))
    L_ref = jax_dml.init_params(jax_dml.DMLConfig(feat_dim=24, l_rank=8),
                                jax.random.PRNGKey(1))
    jidx = JaxExactIndex.build(L_ref, jnp.asarray(x))
    L = metric_factor_from_jax(np.asarray(L_ref), device="cpu")
    assert L.numpy().tobytes() == np.asarray(L_ref).tobytes()
    pidx = exact_index_from_jax(np.asarray(jidx.L), np.asarray(jidx.gp),
                                np.asarray(jidx.gn), device="cpu")
    assert pidx.gp.numpy().tobytes() == np.asarray(jidx.gp).tobytes()
    assert pidx.gn.numpy().tobytes() == np.asarray(jidx.gn).tobytes()
    with pytest.raises(ValueError):
        metric_factor_from_jax(np.zeros(5, np.float32), device="cpu")


def test_same_request_stream_same_neighbours():
    cfg = dict(n_samples=2000, feat_dim=64, n_classes=16,
               kind="noisy_subspace", noise=0.5, seed=0)
    feats, labels = pairs.make_features(pairs.PairDatasetConfig(**cfg))
    L_ref = jax_dml.init_params(jax_dml.DMLConfig(feat_dim=64, l_rank=32),
                                jax.random.PRNGKey(0))
    jidx = JaxExactIndex.build(L_ref, jnp.asarray(feats))
    # the port builds its own index from the carried-over factor
    pidx = ExactIndex.build(metric_factor_from_jax(np.asarray(L_ref), "cpu"),
                            torch.from_numpy(feats), device="cpu")
    rng = np.random.RandomState(1)
    qids = rng.randint(0, len(feats), 90)
    noisy = feats[qids] + 0.1 * rng.randn(90, 64).astype(np.float32)
    ref = JaxRetrievalEngine(jidx, k_top=10)
    eng = RetrievalEngine(pidx, k_top=10)
    # each side projects the gallery itself, so a distance carries the f32
    # rounding of qn + gn - 2 qp.gp: it scales with the operands, not with
    # the (cancelling) result
    qn = np.sum((noisy @ np.asarray(L_ref).T) ** 2, axis=1)
    gn = np.asarray(jidx.gn)
    for lo, hi in ((0, 1), (1, 9), (9, 40), (40, 90), (0, 90)):
        d_ref, i_ref = ref.search(noisy[lo:hi])
        d, i = eng.search(noisy[lo:hi])
        np.testing.assert_array_equal(i, i_ref)
        tol = 1e-5 + 1e-5 * (qn[lo:hi, None] + gn[i_ref])
        assert (np.abs(d - d_ref) <= tol).all()
    st, st_ref = eng.stats(), ref.stats()
    assert (st["n_queries"], st["cache_hits"]) == \
        (st_ref["n_queries"], st_ref["cache_hits"]) == (180, 90)


def test_cli_runs_on_cpu(capsys):
    serve_retrieval.main(["--device", "cpu", "--gallery-size", "2000",
                          "--train-steps", "0", "--requests", "120",
                          "--max-batch", "32"])
    out = capsys.readouterr().out
    assert "(cpu path)" in out and "trained L" not in out
    assert "requests=120" in out and "latency ms: p50=" in out
    purity = float(out.split("purity@10: ")[1].split()[0])
    assert purity > 1.0 / 16


def test_cli_trains_on_cpu(capsys):
    serve_retrieval.main(["--device", "cpu", "--gallery-size", "1500",
                          "--train-steps", "30", "--requests", "60",
                          "--max-batch", "16"])
    out = capsys.readouterr().out
    first, last = map(float, out.split("trained L: objective ")[1]
                      .split()[0:3:2])
    assert last < first
    assert "(cpu path)" in out and "requests=60" in out
    purity = float(out.split("purity@10: ")[1].split()[0])
    assert purity > 1.0 / 16


def test_cli_trains_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_retrieval.main(["--train-steps", "30", "--gallery-size",
                              "1500"])


def test_trained_pipeline_serves_the_reference_neighbours():
    cfg = dict(n_samples=1500, feat_dim=64, n_classes=16,
               kind="noisy_subspace", noise=0.5, seed=0)
    dcfg_ref = jax_dml.DMLConfig(feat_dim=64, l_rank=32)
    train_ref, _ = jax_pairs.train_eval_split(
        jax_pairs.PairDatasetConfig(**cfg), 4000, 4000, 100, 100)
    L_ref, h_ref = jax_train_dml_single(dcfg_ref, train_ref, steps=30,
                                        batch_size=512, lr=2e-2, seed=0)
    L0 = np.asarray(jax_dml.init_params(dcfg_ref, jax.random.PRNGKey(0)))
    train, _ = pairs.train_eval_split(pairs.PairDatasetConfig(**cfg), 4000,
                                      4000, 100, 100)
    L, h = train_dml_single(dml.DMLConfig(feat_dim=64, l_rank=32), train,
                            steps=30, batch_size=512, lr=2e-2, seed=0,
                            L0=L0, device="cpu")
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=1e-4,
                               atol=1e-6)
    assert h[-1]["loss"] < h[0]["loss"]
    feats, _ = pairs.make_features(pairs.PairDatasetConfig(**cfg))
    rng = np.random.RandomState(1)
    q = feats[rng.randint(0, len(feats), 50)] + \
        0.1 * rng.randn(50, 64).astype(np.float32)
    d_ref, i_ref = JaxExactIndex.build(L_ref, jnp.asarray(feats)).topk(
        jnp.asarray(q), 10)
    d, i = ExactIndex.build(L, torch.from_numpy(feats), device="cpu").topk(
        torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-4,
                               atol=1e-4)


# -- the reference's tracing and backend flags -----------------------------------

def test_cli_trace_sample_and_out(tmp_path, capsys):
    """``--trace-sample 0.25`` samples every 4th request (the tracer's
    deterministic accumulator) and ``--trace-out`` writes one span tree
    a sampled request as JSONL."""
    path = tmp_path / "traces.jsonl"
    serve_retrieval.main(["--device", "cpu", "--gallery-size", "1000",
                          "--train-steps", "0", "--requests", "80",
                          "--trace-sample", "0.25", "--trace-out",
                          str(path)])
    out = capsys.readouterr().out
    assert f"traces -> {path} (20 sampled of 80 minted)" in out
    lines = path.read_text().splitlines()
    assert len(lines) == 20
    tree = json.loads(lines[0])
    assert tree["trace_id"]
    names = span_names(tree)
    assert names[0] == "request" and "device_topk" in names


@pytest.mark.parametrize("rate", ["-0.1", "1.5"])
def test_cli_trace_sample_out_of_range(rate, capsys):
    with pytest.raises(SystemExit):
        serve_retrieval.main(["--device", "cpu", "--trace-sample", rate])
    assert "--trace-sample must be in [0, 1]" in capsys.readouterr().err


def test_cli_backend_xla_is_the_plain_path(capsys):
    argv = ["--device", "cpu", "--gallery-size", "1200", "--train-steps",
            "0", "--requests", "40"]
    purity = {}
    for backend in ("xla", "auto"):
        serve_retrieval.main(argv + ["--backend", backend])
        out = capsys.readouterr().out
        assert f"exact scan backend={backend} (plain path)" in out
        purity[backend] = out.split("purity@10: ")[1].split()[0]
    assert purity["xla"] == purity["auto"]


@pytest.mark.parametrize("extra", [[], ["--index", "ivf"],
                                   ["--index", "ivfpq"]])
def test_cli_backend_pallas_is_refused_without_the_kernel(extra, capsys):
    """``pallas`` is the kernel: refused on the CPU, and (as in the
    reference) with the IVF / IVFPQ indexes, whose scans follow
    ``--scan-impl``."""
    with pytest.raises(SystemExit):
        serve_retrieval.main(["--device", "cpu", "--train-steps", "0",
                              "--gallery-size", "200", "--backend",
                              "pallas"] + extra)
    err = capsys.readouterr().err
    assert ("only supports --backend xla" in err if extra
            else "needs the card" in err)


def test_exact_index_backend_knob():
    rng = np.random.RandomState(0)
    L = rng.randn(8, 16).astype(np.float32)
    x = rng.randn(300, 16).astype(np.float32)
    q = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    ref = ExactIndex.build(L, x, device="cpu").topk(q, 7)
    plain = ExactIndex.build(L, x, device="cpu", backend="xla")
    for a, b in zip(plain.topk(q, 7), ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs the card"):
        ExactIndex.build(L, x, device="cpu", backend="pallas").topk(q, 7)
    with pytest.raises(ValueError, match="unknown backend"):
        ExactIndex.build(L, x, device="cpu", backend="cuda")
    from repro_torch.serve import MutableIndex
    mut = MutableIndex.build(L, x, device="cpu")
    mut.base.backend = "xla"
    mut.delete(np.arange(200))
    mut.compact()
    assert mut.base.backend == "xla"
