"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files; a cell added by adding files alone."""

from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil

import pytest

import _tiny
from bench.harness import cell as cells
from bench.harness import registry

ROOT = _tiny.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head|width|"
                   r"proj|feat|expansion|experts_per_tok")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("bench/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not WIDTH.search(key), f"{key} is a width"
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    seen, pairs = set(), set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        seen.add(w["name"])
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == configs, "every configuration is used by some cell"


def test_metrics():
    cellnames = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    names = set()
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert m["moves"] != "setup_s" and _line(m["layer"])
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cellnames)) <= cellnames
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # a per-layer metric's cells report the end-to-end metric it moves
    reports = {m["name"]: set(m.get("workloads", cellnames))
               for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cellnames)) <= reports[m["moves"]]


@pytest.mark.parametrize("name", _tiny.bench().cell_names())
def test_every_cell_resolves_its_files(name):
    cell = _tiny.bench().cell(name)
    assert registry.driver_module(cell.driver).Driver
    assert any(m.name == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.readers) == {m.name for m in cell.per_layer}
    assert all(callable(r) for r in cell.readers.values())
    assert cell.limits, "a cell's check compares at least one number"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in (ROOT / "bench").rglob("*.py")))
def test_no_jax_and_a_plain_reference(path):
    tops = {m.split(".")[0] for m in _imports(ROOT / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if path.startswith("bench/reference/"):
        assert tops <= {"__future__", "numpy", "torch", "bench"}
        assert all(m.startswith("bench.reference") for m in
                   _imports(ROOT / path) if m.split(".")[0] == "bench")
    if not path.startswith("bench/tests/"):
        text = (ROOT / path).read_text()
        assert not re.search(r"BENCH_\w*\.json|benchmarks/", text)


def _digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_adding_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a new traffic mix (data only) and a new cell over an existing config
    (tmp_path / "bench/traffic/search.batch32.json").write_text(json.dumps(
        dict(json.loads((tmp_path / "bench/traffic/search.batch128.json")
                        .read_text()), batch=32)))
    (tmp_path / "bench/limits/imnet63k.search.batch32.json").write_text(
        (tmp_path / "bench/limits/imnet1m.search.batch128.json").read_text())
    spec["workloads"].append({"name": "imnet63k.search.batch32",
                              "config": "dml-imnet63k",
                              "traffic": "search.batch32", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "imnet1m.search.batch128" in m.get("workloads", ()):
            m["workloads"].append("imnet63k.search.batch32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
    cell = _tiny.tiny(registry.Benchmark(tmp_path).cell(
        "imnet63k.search.batch32"))
    out = cells.run(cell, seed=11, seconds=0.5, trace=False, device="cpu",
                    t_start=0.0)
    assert out["correct"] and set(out["metrics"]) == {"search_qps",
                                                      "setup_s"}


def test_held_cells_stay_out_of_the_benchmark():
    held = sorted((ROOT / "bench/held").glob("*.json"))
    assert held
    listed = {m["name"] for key in ("workloads", "end_to_end", "per_layer")
              for m in SPEC[key]}
    for path in held:
        extra = json.loads(path.read_text())
        assert set(extra) == {"why", "workloads", "end_to_end", "per_layer"}
        assert _line(extra["why"])
        assert [w["name"] for w in extra["workloads"]] == [path.stem]
        names = {m["name"] for key in ("workloads", "end_to_end",
                                       "per_layer") for m in extra[key]}
        assert not names & listed
    with pytest.raises(KeyError):
        registry.Benchmark(ROOT).cell(held[0].stem)


def test_a_split_quantity_shares_one_reader():
    assert registry.reader_names("mfu.search_open") == [
        "mfu.search_open", "mfu.search", "mfu"]
    assert registry.reader_names("dml_pair_roofline") == [
        "dml_pair_roofline"]
    paths = {m["name"]: registry.reader_path(m["name"]).name
             for m in _tiny.bench().spec["per_layer"]}
    assert paths["mfu.search_open"] == paths["mfu.search_batch"] \
        == "mfu.search.py"
    assert paths["mfu.train"] == "mfu.train.py"
    assert paths["device_idle_pct.train"] == "device_idle_pct.py"
    # every reader file serves some metric, and none is another's copy
    files = sorted((ROOT / "bench/metrics").glob("*.py"))
    assert {p.name for p in files} == set(paths.values())
    digests = [hashlib.sha256(p.read_bytes()).hexdigest() for p in files]
    assert len(set(digests)) == len(digests)
