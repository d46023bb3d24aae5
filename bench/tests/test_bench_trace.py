"""The reduction of a profiler trace to busy time, operations and idle
gaps, on a made-up trace; the range timer off the card."""

from __future__ import annotations

import pytest

import _tiny  # noqa: F401
from bench.harness.profile import (IDLE_HOST, RangeTimer, reduce_events,
                                   short_name)


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "bench.traced", 0, 1000),
    _x("user_annotation", "bench.loss_fwd", 100, 50),
    _x("cpu_op", "aten::index", 20, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=7),
    _x("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=8),
    _x("cuda_driver", "cuLaunchKernel", 300, 5, corr=9),
    _x("kernel", "void (anonymous namespace)::dml_pair_fwd<128>(float*)",
       200, 100, tid=7, corr=7),
    _x("kernel", "gemm", 250, 150, tid=7, corr=8),         # overlaps
    _x("kernel", "elementwise_kernel", 600, 100, tid=7, corr=9),
    _x("gpu_memcpy", "Memcpy HtoD", 950, 100, tid=7),      # past the end
    _x("cpu_op", "aten::copy_", 420, 150),
    _x("python_function", "ignored", 0, 1000),
]


def test_busy_ranges_ops_and_gaps():
    r = reduce_events(EVENTS)
    assert r["window_s"] == pytest.approx(1e-3)
    # device busy: [200, 400) + [600, 700) + [950, 1000) clipped
    assert r["busy_s"] == pytest.approx(350e-6)
    ops = dict(r["device_ops"])
    assert ops["dml_pair_fwd<128>"] == pytest.approx(100e-6)
    assert ops["Memcpy HtoD"] == pytest.approx(50e-6)
    gaps = dict(r["idle_gaps"])
    # gaps [0, 200) mid 100 -> the loss range; [400, 600) mid 500 ->
    # aten::copy_; [700, 950) mid 825 -> nothing on the host
    assert gaps["bench.loss_fwd"] == pytest.approx(200e-6)
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps[IDLE_HOST] == pytest.approx(250e-6)


def test_no_traced_range_is_an_error():
    with pytest.raises(ValueError):
        reduce_events(EVENTS[1:])


def test_short_names():
    assert short_name("void (anonymous namespace)::scan<64, 8>(float "
                      "const*, int)") == "scan<64, 8>"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::FillFunctor<float>>(int)").startswith(
        "at::native::vectorized_elementwise_kernel<4")
    assert short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"


def test_range_timer_records_host_intervals():
    import torch
    timer = RangeTimer(torch.device("cpu"))
    f = timer.wrap(lambda a, b=1: a + b, "bench.x")
    assert f(1) == 2 and timer.read()["intervals"] == []
    timer.on = True
    assert f(2, b=3) == 5
    r = timer.read()
    assert len(r["intervals"]) == 1 and r["event_s"] == 0
    t0, t1 = r["intervals"][0]
    assert t0 <= t1


def test_range_device_time_by_correlation():
    # the traced range ran over host seconds [10.0, 10.001], so host time
    # t maps to trace microsecond (t - 10.0) * 1e6; one call of the range
    # over host [10.000100, 10.000150] launched corr 7 and 8, another
    # over [10.000290, 10.000310] launched corr 9
    ranges = {"bench.loss_fwd": [(10.000100, 10.000150),
                                 (10.000290, 10.000310)],
              "bench.none": [(10.000900, 10.000910)]}
    r = reduce_events(EVENTS, ranges, (10.0, 10.001))["ranges"]
    loss = r["bench.loss_fwd"]
    assert loss["calls"] == 2 and loss["launches"] == 3
    # the kernels' whole durations, overlap or not: 100 + 150 + 100 us
    assert loss["device_s"] == pytest.approx(350e-6)
    assert r["bench.none"] == {"calls": 1, "device_s": 0.0, "launches": 0}
    # the gaps between launches are not device time: the range's host
    # span and its kernels' span are both longer than what ran
    assert reduce_events(EVENTS)["ranges"] == {}


def test_a_range_maps_by_both_ends_of_the_traced_range():
    # a trace clock that runs from another origin: only the two ends of
    # the traced range tie it to the host's clock
    shifted = [dict(e, ts=e["ts"] + 5e6) for e in EVENTS]
    r = reduce_events(shifted, {"x": [(3.000100, 3.000150)]},
                      (3.0, 3.001))["ranges"]["x"]
    assert r["launches"] == 2 and r["device_s"] == pytest.approx(250e-6)
