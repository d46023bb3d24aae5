"""Whole runs of each cell at the CPU's size: the result line's shape,
``correct`` true on the sound path and false with each fault planted
under the timed path; no JAX in the process; no result without a card.

``bench/run.py`` refuses to run without CUDA, so these drive the rest of
a run (``cell.run``) on the CPU with the port's plain paths.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import _tiny
from bench.harness import cell as cells
from bench.tools.faults import FAULTS

ROOT = _tiny.ROOT
CELLS = [w for w in _tiny.bench().cell_names()]
BY_DRIVER = {}
for _name in CELLS:
    BY_DRIVER.setdefault(_tiny.bench().cell(_name).driver, _name)


def _run(name, trace=False, hooks=(), seed=2_147_483_659, seconds=0.8):
    cell = _tiny.tiny(_tiny.bench().cell(name))
    return cells.run(cell, seed=seed, seconds=seconds, trace=trace,
                     device="cpu", t_start=0.0, hooks=hooks)


@pytest.mark.parametrize("name", sorted(BY_DRIVER.values()))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(name, trace):
    out = _run(name, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    cell = _tiny.bench().cell(name)
    if trace:
        assert set(out["metrics"]) <= {m.name for m in cell.per_layer}
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m.name for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    for c in out["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]
    json.dumps(out, allow_nan=False)


FAULT_CASES = [(name, fault) for drv, name in sorted(BY_DRIVER.items())
               for fault in FAULTS[drv]]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    drv = _tiny.bench().cell(name).driver
    out = _run(name, hooks=[FAULTS[drv][fault]])
    assert out["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in out["checks"].values())


@pytest.mark.parametrize("driver", ["train_ps", "search_closed"])
def test_same_seed_same_inputs(driver):
    cell = _tiny.tiny(_tiny.bench().cell(BY_DRIVER[driver]))
    from bench.harness import registry
    built = []
    for seed in (5, 5, 6):
        drv = registry.driver_module(driver).Driver(cell.config,
                                                    cell.traffic, seed, "cpu")
        drv.build()
        built.append((drv.pool, drv.L0) if driver == "train_ps"
                     else (torch.from_numpy(drv.queries), drv.index.gp))
        drv.close()
    assert all(torch.equal(a, b) for a, b in zip(built[0], built[1]))
    assert not any(torch.equal(a, b) for a, b in zip(built[0], built[2]))


PROBE = """
import sys, json
sys.path[:0] = [{root!r}, {root!r} + "/bench/tests"]
import _tiny
from bench.harness import cell as cells
cell = _tiny.tiny(_tiny.bench().cell({name!r}))
out = cells.run(cell, seed=3, seconds=0.3, trace=False, device="cpu",
                t_start=0.0)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": out["correct"], "tops": tops}}))
"""


@pytest.mark.parametrize("driver", sorted(BY_DRIVER))
def test_the_run_loads_no_jax(driver):
    code = PROBE.format(root=str(ROOT), name=BY_DRIVER[driver])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert not set(out["tops"]) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in out["tops"]


def test_no_result_without_a_card():
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_unknown_workload():
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "no.such.cell",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_one_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "imnet1m.search.batch128", "--seed", "2147483901", "--seconds",
         "2", "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
