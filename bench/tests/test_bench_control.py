"""The control: the plain reference in float32 with TF32 products (one
step below the configurations' float32), put in the program's place,
has to come out not correct under each cell's limits. On the chip it is
read at the cells' own sizes (``bench/tools/readings.py``); here at a
size a test run holds."""

from __future__ import annotations

import pytest

import _tiny
from bench.harness import judge, registry
from bench.harness.drivers import train_ps

SEARCH = {"feat_dim": 2048, "proj_dim": 128, "n_samples": 20000}


def _driver(name, sizes):
    cell = _tiny.tiny(_tiny.bench().cell(name))
    cell_cfg = dict(cell.config, **sizes)
    drv = registry.driver_module(cell.driver).Driver(cell_cfg, cell.traffic,
                                                     2_147_483_001, "cpu")
    drv.build()
    drv.warm()
    return cell, drv


@pytest.mark.parametrize("name", ["imnet1m.train.bsp", "imnet63k.train.bsp"])
def test_training_control_is_not_correct(name):
    cell, drv = _driver(name, {})
    win = drv.window(0.2, trace=False)
    sound = drv.check(win)
    assert judge.judge(sound, cell.limits)[0]
    low = train_ps.as_program_output(drv.reference("tf32"), drv.P)
    control = judge.train_numbers(low, drv.ref64, drv.L0, drv.lr1())
    correct, checks = judge.judge(control, cell.limits)
    assert not correct, checks


@pytest.mark.parametrize("name", ["imnet1m.search.open",
                                  "imnet1m.search.batch128"])
def test_search_control_is_not_correct(name):
    cell, drv = _driver(name, SEARCH)
    try:
        win = drv.window(0.5, trace=False)
        sound = drv.check(win)
    finally:
        drv.close()
    assert judge.judge(sound, cell.limits)[0]
    rows = drv.checked[0]
    control = drv.judge_answers(rows, *drv.control_answers(rows, "tf32"))
    control["lost"] = 0
    correct, checks = judge.judge(control, cell.limits)
    assert not correct, checks
