"""The readers' operation and byte counts against hand counts at the
cells' sizes, and each reader's arithmetic on a made-up run."""

from __future__ import annotations

import types

import pytest

import _tiny
from bench.harness import device, registry

H100 = device.peaks("NVIDIA H100 80GB HBM3")
B = _tiny.bench()
IM1M = B.cell("imnet1m.train.bsp").config
IM63K = B.cell("imnet63k.train.bsp").config
TRAIN = B.cell("imnet1m.train.bsp").traffic


def _module(name):
    return registry.load_reader(name).__globals__


def test_peaks_are_the_data_sheet():
    assert H100 == {"f32_product_flops": 495e12, "hbm_bytes_per_s": 3.35e12}
    assert device.peaks("cpu") is None


def test_dml_pair_forward_imnet1m_is_bound_by_operations():
    ops, nbytes = _module("dml_pair_roofline")["forward_work"](IM1M)
    # 2 B d_in d_out FLOP of the projection, plus z = x - y and the hinge
    assert ops == 2 * 1000 * 21504 * 1000 + 1000 * 21504 + 3 * 1000 * 1000
    # xs, ys, L, sim in; loss, d2 and the (B, d_out) projection out
    assert nbytes == 4 * (2 * 1000 * 21504 + 1000 * 21504 + 1000) \
        + 4 * (1 + 1000 + 1000 * 1000)
    assert device.least_seconds(ops, nbytes, H100) == pytest.approx(
        0.0869e-3, rel=2e-3)
    assert ops / H100["f32_product_flops"] > nbytes / H100["hbm_bytes_per_s"]


def test_dml_pair_forward_imnet63k_is_bound_by_bytes():
    ops, nbytes = _module("dml_pair_roofline")["forward_work"](IM63K)
    assert nbytes == pytest.approx(881.4e6, rel=1e-3)      # L is 860 MB
    assert device.least_seconds(ops, nbytes, H100) == pytest.approx(
        0.263e-3, rel=2e-3)


def test_step_flop():
    f = _module("mfu.train")["step_flop"]
    assert f(IM1M, TRAIN) == 4 * 4 * 1000 * 21504 * 1000 == 3.44064e11
    assert f(IM63K, TRAIN) == 4 * 4 * 100 * 21504 * 10000 == f(IM1M, TRAIN)


@pytest.mark.parametrize("cell", ["search_open", "search_batch"])
def test_metric_topk_call(cell):
    work = _module(f"metric_topk_roofline.{cell}")["call_work"]
    ops, nbytes = work(IM1M, 1, 10)
    assert ops == 2 * 21504 * 1000 + 2 * 1_000_000 * 1000
    assert nbytes == 4 * (21504 + 1000 * 21504 + 1_000_000 * 1000
                          + 1_000_000) + 8 * 10
    assert device.least_seconds(ops, nbytes, H100) == pytest.approx(
        1.2213e-3, rel=1e-3)
    # bytes bound it up to about 296 rows, operations past that
    for n, by_bytes in ((295, True), (298, False)):
        ops, nbytes = work(IM1M, n, 10)
        assert (nbytes / H100["hbm_bytes_per_s"]
                > ops / H100["f32_product_flops"]) is by_bytes
    q = _module(f"mfu.{cell}")["query_flop"](IM1M)
    assert q == 2 * 21504 * 1000 + 2 * 1_000_000 * 1000 == 2.043008e9


def _run(**window):
    trace = window.pop("trace", None)
    return types.SimpleNamespace(config=IM1M, traffic=dict(TRAIN, k=10),
                                 window=window, trace=trace, peak=H100)


def test_mfu_train_leaves_out_the_profiled_stretch():
    read = registry.load_reader("mfu.train")
    run = _run(steps=1000, traced_steps=200, seconds=12.0, traced_s=4.0)
    assert read(run) == pytest.approx(100 * 800 * 3.44064e11 / (8 * 495e12))
    assert read(_run(steps=0, traced_steps=0, seconds=1.0,
                     traced_s=0.0)) is None


def test_roofline_readers():
    # device seconds of what the ranges' calls launched, from the trace
    ranges = {"bench.loss_fwd": {"calls": 4, "device_s": 4e-3,
                                 "launches": 8},
              "bench.topk": {"calls": 2, "device_s": 4e-3, "launches": 6}}
    trace = {"busy_s": 0.75, "window_s": 1.0, "ranges": ranges}
    run = _run(trace=trace, topk_rows=[8, 8])
    rf = registry.load_reader("dml_pair_roofline")(run)
    assert rf == pytest.approx(100 * 0.0869e-3 / 1e-3, rel=2e-3)
    tk = registry.load_reader("metric_topk_roofline.search_batch")(run)
    assert tk == pytest.approx(100 * 1.2214e-3 / 2e-3, rel=1e-3)
    run.window.update(steps=300, traced_steps=100, seconds=3.0,
                      traced_s=1.5)
    # 7.5 ms busy a traced step, 7.5 ms a step outside the stretch
    assert registry.load_reader("device_idle_pct.train")(run) == \
        pytest.approx(100 * (1 - 0.0075 / 0.0075))
    run.window.update(traced_s=1.0)
    assert registry.load_reader("device_idle_pct.train")(run) == \
        pytest.approx(25.0)
    empty = _run(trace=None)
    for name in ("dml_pair_roofline", "metric_topk_roofline.search_open",
                 "device_idle_pct.search_open"):
        assert registry.load_reader(name)(empty) is None
    # a range whose calls launched nothing that the trace holds reads
    # nothing, not a share of 0 or of infinity
    none = _run(trace=dict(trace, ranges={}), topk_rows=[8])
    for name in ("dml_pair_roofline", "metric_topk_roofline.search_batch"):
        assert registry.load_reader(name)(none) is None


def test_idle_share_of_a_search_cell_counts_queries():
    run = _run(trace={"busy_s": 0.5, "ranges": {}}, answered=9000,
               answered_traced=1000, seconds=9.0, traced_s=1.0)
    # 0.5 ms busy a traced query, 1 ms a query outside the stretch
    assert registry.load_reader("device_idle_pct.search_batch")(run) == \
        pytest.approx(50.0)


def test_counter_and_span_readers():
    run = _run(batches=100, requests=850,
               engine_spans={"host_s": 0.05, "calls": 100})
    assert registry.load_reader("batch_size_mean.search_open")(run) == 8.5
    assert registry.load_reader("engine_host_ms.search_open")(run) == \
        pytest.approx(0.5)
    run = _run(answered=20000, answered_traced=4000, seconds=10.0,
               traced_s=2.0)
    assert registry.load_reader("mfu.search_batch")(run) == pytest.approx(
        100 * 16000 * 2.043008e9 / (8 * 495e12))
