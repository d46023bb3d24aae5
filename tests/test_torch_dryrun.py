"""The dry-run account (``repro_torch.launch.cost_analysis``,
``repro_torch.launch.dryrun``): ``roofline_terms`` against the
reference's, FLOPs and bytes against hand counts (a 2-layer dense
config, the Eq. 4 step), the peak against a scripted sequence of
allocations and frees, one arch of each family against the model FLOPs
of ``benchmarks/roofline.py``, and the record's invariants at the H100's
rates. Everything runs on ``meta`` tensors: nothing is allocated.
"""

import itertools
import json

import pytest
import torch

from benchmarks import roofline as ref_roofline
from repro.launch import hlo_analysis

from repro_torch.configs import SHAPES, get_config, get_shape, list_configs
from repro_torch.configs.base import InputShape, RunConfig
from repro_torch.core.dml import DMLConfig
from repro_torch.launch import cost_analysis, dryrun, mesh as mesh_lib, steps
from repro_torch.models import Model

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# --------------------------------------------------------------------------
# roofline_terms
# --------------------------------------------------------------------------

_GRID = list(itertools.product(
    (0.0, 1.0, 2.709e11, 3.3e17), (0.0, 7.0, 4.03e10, 2.8e15),
    (0.0, 1e9), (1, 256, 512), (197e12, 989e12, 67e12),
    (819e9, 3.35e12), (50e9, 450e9)))


@pytest.mark.parametrize("chunk", range(4))
def test_roofline_terms_equal_reference(chunk):
    for args in _GRID[chunk::4]:
        if args[0] == args[1] == args[2] == 0.0:
            continue
        assert cost_analysis.roofline_terms(*args) == \
            hlo_analysis.roofline_terms(*args), args


# --------------------------------------------------------------------------
# the counting rules
# --------------------------------------------------------------------------

def test_peak_on_a_scripted_sequence():
    """Live bytes rise when an op returns a new storage and fall when its
    last reference dies; views and in-place ops allocate nothing."""
    mode = cost_analysis.CostMode()
    x0 = _meta(10)                               # an argument: 40 bytes
    assert mode.add_arguments({"x": x0}) == 40
    with mode:
        a = torch.ones(1000, device=META)        # 4000 live
        b = a + 1                                # 8000
        v = b.view(10, 100)                      # a view: 8000
        del a                                    # 4000
        c = torch.zeros(250, dtype=torch.float64, device=META)   # 6000
        c.add_(1.0)                              # in place: 6000
        del b                                    # v holds b: 6000
        d = torch.empty(3000, device=META)       # 18000: the peak
        del v, d                                 # 2000
        e = torch.ones(4000, device=META)        # 18000 again
        del c, e                                 # 0
        f = x0 * 2                               # 40
    assert mode.peak == 18000
    assert mode.live == 40
    assert mode.new_bytes({"f": f, "x": x0}) == 40
    assert mode.argument_bytes == 40


def test_bytes_and_flops_rules_by_op():
    mode = cost_analysis.CostMode()
    a, b = _meta(6, 5), _meta(5, 3, dtype=torch.bfloat16)
    idx = _meta(4, dtype=torch.int64)
    with mode:
        a.t()                                    # view: nothing
        a.reshape(30)                            # view: nothing
        a[:, 1:3].sum()                          # reads the slice only
        a.to(torch.bfloat16) @ b                 # 60 + 120 (cast); mm
        a[idx]                                   # gather: 2 x out
        torch.zeros(6, 5, device=META).index_put_(
            (idx,), _meta(4, 5))                 # fill, then 2 x update
        torch.empty(100, device=META)            # nothing
    # 8 ops: the 7 above that move bytes or allocate, and the empty
    # that made index_put_'s values inside the mode
    assert mode.flops == {"bfloat16": 2.0 * 6 * 5 * 3}
    expect = (4 * 12 + 4) + (4 * 30 + 2 * 30) + \
        (2 * 30 + 2 * 15 + 2 * 18) + 2 * (4 * 20) + 4 * 30 + 2 * (4 * 20)
    assert mode.bytes == expect
    assert mode.ops == 8


def _dml_hand_count(B, d, k):
    """The Eq. 4 step (``dryrun._dml_step``: the loss through the plain
    forward and the closed-form backward, its aux statistics, L - 0.01 g)
    op by op, f32 (4 bytes), int32 sim, bool masks (1 byte)."""
    fwd = (12 * B * d                    # z = xs - ys
           + 4 * (B * d + k * d + B * k)  # proj = z @ L.T
           + 8 * B * k                   # proj ** 2
           + 4 * B * k + 4 * B           # d2 = sum(., -1)
           + 8 * B                       # simf = sim.to(f32)
           + 8 * B + 8 * B               # margin - d2, clamp_min
           + 12 * B                      # simf * d2
           + 8 * B + 8 * B + 12 * B      # 1 - simf, * lam, * hinge
           + 12 * B                      # losses = . + .
           + 4 * B + 4)                  # mean
    aux = (8 * B                          # simf
           + 12 * B + 4 * B + 4          # sum(d2 * simf)
           + 4 * B + 4 + 8 + 12          # sum(simf), clamp_min, div
           + 8 * B + 12 * B + 4 * B + 4  # sum(d2 * (1 - simf))
           + 8 * B + 4 * B + 4 + 8 + 12  # sum(1 - simf), clamp_min, div
           + 5 * B + 8 * B + 9 * B + 4 * B + 4)   # mean((d2<m)*(1-simf))
    bwd = (4                              # the seed, ones_like
           + 4 * B                       # zeros for d2's (unused) grad
           + 8 * B + 5 * B + 5 * B       # simf, d2 < margin, .to(f32)
           + 8 * B + 8 * B + 12 * B      # 1 - simf, * lam, * active
           + 12 * B                      # w = simf - .
           + 8 * B * k + 4 * B           # pw = proj * w[:, None]
           + 8 + 8                       # scale = 2 * g / B
           + 12 * B * d                  # z = xs - ys
           + 8 * B * k + 4               # scale * pw.T
           + 4 * (k * B + B * d + k * d))   # dL = . @ z
    update = 8 * k * d + 12 * k * d       # 0.01 * g, L - .
    return fwd + aux + bwd + update


@pytest.mark.parametrize("B,d,k", [(7, 12, 5), (64, 300, 40)])
def test_dml_step_flops_and_bytes_equal_hand_count(B, d, k):
    dcfg = DMLConfig(feat_dim=d, proj_dim=k)
    L = _meta(k, d)
    batch = {"xs": _meta(B, d), "ys": _meta(B, d),
             "sim": _meta(B, dtype=torch.int32)}
    rec = dryrun.account(dryrun._dml_step(dcfg), L, batch)
    assert rec["flops_by_dtype"] == {"float32": 2.0 * (2 * B * d * k)}
    assert rec["hbm_bytes_per_chip"] == _dml_hand_count(B, d, k)
    assert rec["memory"]["argument_size"] == 4 * (k * d + 2 * B * d) + 4 * B
    assert rec["memory"]["output_size"] == 4 * k * d + 4


def _dense_cfg():
    return get_config("smollm-135m-reduced").replace(n_layers=2)


def _dense_hand_count(cfg, B, T):
    """(FLOPs, bytes) of the dense forward (``Model.apply(plain=True)``:
    naive attention at T <= 2048) op by op: f32 weights cast to the bf16
    activations at each product, RMSNorm and RoPE in f32, scores in f32,
    tied unembedding."""
    N, d, H, K, f, V = B * T, cfg.d_model, cfg.n_heads, cfg.kv_heads, \
        cfg.d_ff, cfg.vocab_size
    Dh, S = cfg.dim_per_head, T
    BHT2 = B * H * T * S

    def linear(n_in, n_out):        # w.to(bf16), then x @ w
        return 6 * n_in * n_out + 2 * (N * n_in + n_in * n_out + N * n_out)

    norm = 40 * N * d + 24 * N + 4 * d

    def rope(h):
        return 20 * Dh + 16 * N + 18 * N * Dh + 48 * N * h * Dh

    attend = (12 * N * H * Dh + 12 * N * K * Dh + 48 * BHT2
              + 48 * T + 6 * T * S)
    layer = (norm + linear(d, H * Dh) + 2 * linear(d, K * Dh)
             + rope(H) + rope(K) + attend + linear(H * Dh, d) + 6 * N * d
             + norm + 2 * linear(d, f) + 4 * N * f + 6 * N * f
             + linear(f, d) + 6 * N * d)
    embed = 2 * 4 * N * d + 6 * N * d + 8 * T
    moe_aux = 4                     # the f32 zero the dense family sums
    nbytes = embed + cfg.n_layers * layer + moe_aux + norm + linear(d, V)
    gemm = 2 * N * d * (H + 2 * K) * Dh + 2 * 2 * B * H * T * S * Dh + \
        2 * N * H * Dh * d + 3 * 2 * N * d * f
    flops = cfg.n_layers * gemm + 2 * N * d * V
    return flops, nbytes


@pytest.mark.parametrize("B,T", [(2, 16), (3, 40)])
def test_dense_forward_flops_and_bytes_equal_hand_count(B, T):
    cfg = _dense_cfg()
    model = Model(cfg, device="meta")
    specs = steps.input_specs(cfg, InputShape("p", T, B, "prefill"))
    rec = dryrun.account(lambda p, b: model.apply(b, plain=True)[0],
                         model.param_tree(), specs)
    flops, nbytes = _dense_hand_count(cfg, B, T)
    assert rec["flops_by_dtype"] == {"bfloat16": flops}
    assert rec["hbm_bytes_per_chip"] == nbytes
    n_params = sum(p.numel() for p in model.parameters())
    assert rec["memory"]["argument_size"] == 4 * n_params + 4 * B * T
    assert rec["memory"]["output_size"] == 2 * B * T * cfg.vocab_size


def test_dense_train_step_flops_are_four_forwards():
    """Under remat (the RunConfig default) each product runs forward,
    again in the recomputation, and twice in backward (the input's and
    the weight's gradients); the chunked cross-entropy recomputes its
    unembedding the same way. A layer's recomputation stops at the last
    tensor its backward saved (``torch.utils.checkpoint``'s early stop),
    so the MLP's down projection, whose output no backward reads, runs
    once a layer, not twice."""
    cfg, B, T = _dense_cfg(), 2, 16
    model = Model(cfg, device="meta")
    run = RunConfig(arch=cfg.name)
    assert run.remat
    opt = steps.make_optimizer(run)
    rec = dryrun.account(steps.make_train_step(model, opt, run),
                         steps.init_train_state(model, opt),
                         steps.input_specs(cfg, InputShape("t", T, B,
                                                           "train")))
    down = 2 * B * T * cfg.d_ff * cfg.d_model
    assert rec["flops_by_dtype"] == {
        "bfloat16": 4 * _dense_hand_count(cfg, B, T)[0]
        - cfg.n_layers * down}


# --------------------------------------------------------------------------
# model FLOPs, one arch a family, and the record
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_are_benchmarks_roofline_s(arch):
    for shape in SHAPES:
        assert dryrun.model_flops(get_config(arch), get_shape(shape)) == \
            ref_roofline.model_flops(arch, shape)
    assert dryrun.param_counts(get_config(arch)) == \
        ref_roofline.param_counts(get_config(arch))


# counted / model FLOPs at B 2, T 64 on the reduced configs: at most this
# factor. The count adds what 6ND / 2ND / 2NB leave out: the unembedding
# (vocab 512 at d 256: a layer's worth of products), attention's scores
# (the full masked T x S in the plain forms), the SSD and rwkv6 chunk
# products, and under remat a second forward in training (8ND, not 6ND,
# before the rest); decode adds its products against the T-slot cache.
# The moe family's experts compute every capacity slot (``moe._capacity``:
# C = int(2 * N * k / E) + 8 an expert), so at decode's N = 2 tokens its 4
# experts compute 40 slots for 4 routed pairs.
FAMILY_ARCHS = {"dense": "smollm-135m", "hybrid": "zamba2-2.7b",
                "ssm": "rwkv6-1.6b", "moe": "granite-moe-1b-a400m",
                "vlm": "pixtral-12b", "audio": "hubert-xlarge"}
UPPER = {"train": 3.0, "prefill": 3.0, "decode": 3.0, "moe-decode": 15.0}


@pytest.mark.parametrize("family,mode", [
    (f, m) for f in sorted(FAMILY_ARCHS) for m in ("train", "prefill",
                                                   "decode")
    if (f, m) != ("audio", "decode")])        # encoder-only: no decode
def test_counted_flops_cover_model_flops(family, mode):
    cfg = get_config(FAMILY_ARCHS[family] + "-reduced")
    assert cfg.family == family
    shape = InputShape(mode, 64, 2, mode)
    model = Model(cfg, device="meta")
    run = RunConfig(arch=cfg.name)
    specs = steps.input_specs(cfg, shape)
    if mode == "train":
        opt = steps.make_optimizer(run)
        rec = dryrun.account(steps.make_train_step(model, opt, run),
                             steps.init_train_state(model, opt), specs)
    elif mode == "prefill":
        rec = dryrun.account(lambda p, b: model.apply(b, plain=True)[0],
                             model.param_tree(), specs)
    else:
        serve = steps.make_serve_step(model, run)
        rec = dryrun.account(
            lambda p, c, b: serve(c, b), model.param_tree(),
            steps.cache_shape_structs(model, shape),
            {"tokens": specs["tokens"], "pos": shape.seq_len - 1})
    ratio = rec["flops_per_chip"] / dryrun.model_flops(cfg, shape)
    assert 1.0 <= ratio <= UPPER.get(f"{family}-{mode}", UPPER[mode]), ratio


def _check_record(rec):
    """The reference's record invariants (``test_roofline_terms_consistent``)
    at the H100's rates: each dtype's FLOPs at its rate."""
    t = rec["roofline"]
    compute_s = sum(f / mesh_lib.PEAK_FLOPS_BY_DTYPE[dt]
                    for dt, f in rec["flops_by_dtype"].items())
    assert t["compute_s"] == pytest.approx(compute_s, rel=1e-12)
    assert t["compute_s"] == pytest.approx(
        rec["flops_per_chip"] / rec["peak_flops"], rel=1e-12)
    assert t["memory_s"] == pytest.approx(
        rec["hbm_bytes_per_chip"] / mesh_lib.HBM_BW, rel=1e-12)
    assert t["collective_s"] == 0.0
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["dominant"] == ("compute" if t["compute_s"] >= t["memory_s"]
                             else "memory")
    m = rec["memory"]
    assert rec["peak_bytes"] == m["argument_size"] + m["temp_size"]
    assert rec["fits_80gb"] == (rec["peak_bytes"] <= 80e9)
    assert m["output_size"] <= m["temp_size"] or m["output_size"] == 0
    json.dumps(rec)


@pytest.mark.parametrize("arch,shape_name", [
    ("smollm-135m", "decode_32k"), ("rwkv6-1.6b", "long_500k"),
    ("hubert-xlarge", "decode_32k")])
def test_dryrun_one_record(arch, shape_name):
    rec = dryrun.dryrun_one(arch, shape_name)
    if arch == "hubert-xlarge":
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok"
    assert rec["mesh"] == {"data": 1, "model": 1} and rec["n_chips"] == 1
    assert rec["mode"] == "decode" and rec["card"] == mesh_lib.CARD
    _check_record(rec)
    assert rec["flops_per_chip"] >= rec["model_flops"]


def test_dryrun_dml_records():
    recs = dryrun.dryrun_dml()
    assert sorted(recs) == ["dml-imnet1m", "dml-imnet63k", "dml-mnist"]
    for name, rec in recs.items():
        _check_record(rec)
        exp = {"dml-mnist": (1000, 780, 600),
               "dml-imnet63k": (100, 21504, 10000),
               "dml-imnet1m": (1000, 21504, 1000)}[name]
        B, d, k = exp
        assert rec["global_pair_batch"] == B
        assert rec["flops_by_dtype"] == {"float32": 4.0 * B * d * k}
    ranks = dryrun.dryrun_dml("pod2x16x16")
    # rank 0's program: the pairs over pod x data, 1000 a rank
    assert ranks["dml-imnet1m"]["status"] == "ok"
    assert ranks["dml-imnet1m"]["memory"]["argument_size"] == \
        4 * 1000 * 21504 + 2 * 4 * 1000 * 21504 + 4 * 1000
    # (1000 rows do not divide the model axis of 16: L is replicated)
    assert not ranks["dml-imnet1m"]["rows_split"]
    assert ranks["dml-imnet1m"]["global_pair_batch"] == 32_000


def test_cli_writes_under_build(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k"])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "long_500k"])
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--multi-pod"])
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                 "--multi-pod"])
    recs = json.loads((tmp_path / "dryrun_h100.json").read_text())
    assert recs["smollm-135m|decode_32k"]["status"] == "ok"
    assert recs["hubert-xlarge|long_500k"]["status"] == "skipped"
    pod = json.loads((tmp_path / "dryrun_pod2x16x16.json").read_text())
    # the dense family's rank program, and the ssm family's (its wkv
    # state and token shifts in the plan's stacked layout)
    assert pod["smollm-135m|decode_32k"]["status"] == "ok"
    assert pod["smollm-135m|decode_32k"]["n_chips"] == 512
    rwkv = pod["rwkv6-1.6b|decode_32k"]
    assert rwkv["status"] == "ok"
    assert rwkv["memory"]["argument_size"] == rwkv["plan"]["argument_size"]
    assert dryrun._artifact_path("h100").startswith(str(tmp_path))


def test_sweep_in_processes_equals_in_process():
    """``sweep`` (the CLI's ``--jobs`` and chip_smoke.py's phase 19): the
    same records in a pool of spawned processes as in this one, and a
    job that raises becomes an "error" record."""
    jobs = [dryrun.Job("smollm-135m", "train_4k", {"n_layers": 2}),
            dryrun.Job("yi-6b", "decode_32k", {"n_layers": 4}),
            dryrun.Job("granite-moe-1b-a400m", "decode_32k"),
            dryrun.Job("rwkv6-1.6b", "decode_32k"),
            dryrun.Job("no-such-arch", "train_4k")]
    here = dict(dryrun.sweep(jobs, "16x16"))
    pooled = dict(dryrun.sweep(jobs, "16x16", procs=2))
    for rec in list(here.values()) + list(pooled.values()):
        rec.pop("trace_s", None)            # a host clock's reading
    assert here == pooled
    # each job in a fake world of its own, in this process or a spawned one
    assert here["smollm-135m|train_4k"]["status"] == "ok"
    assert here["granite-moe-1b-a400m|decode_32k"]["status"] == "ok"
    assert here["rwkv6-1.6b|decode_32k"]["status"] == "ok"
    assert here["no-such-arch|train_4k"]["status"] == "error"
    cut = here["yi-6b|decode_32k"]["plan"]
    full = dryrun.plan_arguments(
        get_config("yi-6b"), get_shape("decode_32k"),
        mesh_lib.MESHES["16x16"])
    assert cut["cache"] * 8 == full["cache"]        # 4 of 32 layers


def test_artifacts_go_to_build_not_benchmarks():
    path = dryrun.ARTIFACT_DIR.replace("\\", "/")
    assert path.endswith("/build/dryrun")
    assert "benchmarks" not in path
