"""Everything a cell needs, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The harness finds, by name alone:

  * the configuration: the ``file`` its ``configs`` entry gives
    (``bench/configs/<config>.json``);
  * the traffic mix: ``bench/traffic/<traffic>.json``, a data file whose
    ``driver`` key names the general loop that reads it
    (``bench/harness/drivers/<driver>.py``);
  * the limits of its correctness check: ``bench/limits/<cell>.json``;
  * each per-layer metric's reader: ``bench/metrics/<metric>.py``, or,
    for a quantity split by the end-to-end metric it moves
    (``mfu.search_open``, ``mfu.search_batch``), the file of the longest
    part of its name cut at a ``.`` or ``_`` after the first ``.``
    (``mfu.search.py``), or of the part before the first ``.``.

So a cell is added by adding files and one ``workloads`` entry; no file
that is there is edited.

A cell held out of ``BENCHMARK.json`` keeps its entries in
``bench/held/<cell>.json`` (its ``workloads``, ``end_to_end`` and
``per_layer`` entries, and why it is held): the benchmark's runs do not
know it, and the tools and tests that drive it load it with
``Benchmark(root, held=True)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple        # the cells that report it (all when empty)
    moves: str = ""         # per-layer: the end-to-end metric it moves
    layer: str = ""

    def applies(self, cell: str) -> bool:
        return not self.workloads or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple       # Metric, in BENCHMARK.json's order
    per_layer: tuple        # Metric
    readers: Dict[str, Callable]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(entry: dict) -> Metric:
    return Metric(name=entry["name"], unit=entry["unit"],
                  better=entry["better"], source=entry["source"],
                  workloads=tuple(entry.get("workloads", ())),
                  moves=entry.get("moves", ""), layer=entry.get("layer", ""))


def reader_names(name: str) -> List[str]:
    """The reader files that may serve a metric, most specific first:
    its whole name, then its name cut at each ``.`` or ``_`` after the
    first ``.``, from the right."""
    base, dot, rest = name.partition(".")
    out = [name]
    for i in range(len(rest) - 1, -1, -1):
        if rest[i] in "._":
            out.append(f"{base}.{rest[:i]}")
    if dot:
        out.append(base)
    return out


def reader_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    for cand in reader_names(name):
        path = bench_dir / "metrics" / f"{cand}.py"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{bench_dir / 'metrics'}")


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The ``read`` function of the metric's reader file (a metric's name
    may hold dots, so the file is loaded by path)."""
    path = reader_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(name: str):
    """The general loop that a traffic file's ``driver`` names."""
    return importlib.import_module(f"bench.harness.drivers.{name}")


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path, held: bool = False):
        self.root = Path(root)
        self.bench_dir = self.root / "bench"
        self.spec = _json(self.root / "BENCHMARK.json")
        if held:
            for path in sorted((self.bench_dir / "held").glob("*.json")):
                extra = _json(path)
                for key in ("workloads", "end_to_end", "per_layer"):
                    self.spec[key] = self.spec[key] + extra[key]
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.workloads = {w["name"]: w for w in self.spec["workloads"]}
        self.end_to_end = [_metric(m) for m in self.spec["end_to_end"]]
        self.per_layer = [_metric(m) for m in self.spec["per_layer"]]

    def cell_names(self) -> List[str]:
        return list(self.workloads)

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has "
                           f"{sorted(self.workloads)}")
        w = self.workloads[name]
        config = _json(self.root / self.configs[w["config"]]["file"])
        traffic = _json(self.bench_dir / "traffic" / f"{w['traffic']}.json")
        limits = _json(self.bench_dir / "limits" / f"{name}.json")
        per_layer = tuple(m for m in self.per_layer if m.applies(name))
        return Cell(name=name, chips=int(w["chips"]), config=config,
                    traffic=traffic, limits=limits,
                    end_to_end=tuple(m for m in self.end_to_end
                                     if m.applies(name)),
                    per_layer=per_layer,
                    readers={m.name: load_reader(m.name, self.bench_dir)
                             for m in per_layer})
