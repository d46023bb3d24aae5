"""The port stands alone: no jax, nothing of ``repro``, no quiet CPU.

An AST scan holds every module under ``src/repro_torch`` and
``chip_smoke.py`` to imports of torch, numpy and the standard library;
the default-device entry points must raise when there is no card; and
``chip_smoke.py`` must fail without a card and outside the repository.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import dml
from repro_torch.core.eval_tasks import (knn_accuracy, knn_classify,
                                         metric_kmeans)
from repro_torch.core.ps import sync
from repro_torch.core.ps.trainer import (DMLTrainConfig,
                                         train_dml_distributed,
                                         train_dml_single)
from repro_torch.data import pairs
from repro_torch.device import resolve_device
from repro_torch.launch import serve_retrieval
from repro_torch.serve import ExactIndex

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_port():
    assert len(PORT_FILES) > 20
    assert _forbidden("repro.serve") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.serve")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExactIndex.build(np.eye(4, dtype=np.float32),
                         np.ones((8, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_retrieval.main(["--gallery-size", "100"])
    assert resolve_device("cpu").type == "cpu"


def _tiny_pairs():
    x, y = pairs.make_features(pairs.PairDatasetConfig(80, 8, 2, seed=0))
    return x, y, pairs.sample_pairs(x, y, 40, 40)


_CFG = dml.DMLConfig(feat_dim=8, proj_dim=4)
_ENTRY_POINTS = {
    "train_dml_single": lambda x, y, p: train_dml_single(_CFG, p, steps=1),
    "train_dml_distributed": lambda x, y, p: train_dml_distributed(
        DMLTrainConfig(dml=_CFG, ps=sync.PSConfig(n_workers=2), steps=1),
        p),
    "knn_accuracy": lambda x, y, p: knn_accuracy(None, x, y, x, y),
    "knn_classify": lambda x, y, p: knn_classify(None, x, y, x),
    "metric_kmeans": lambda x, y, p: metric_kmeans(None, x, 2),
    "pair_batches": lambda x, y, p: pairs.pair_batches(p, 8),
    "pair_batches_from_indices": lambda x, y, p:
        pairs.pair_batches_from_indices(x, pairs.sample_pair_indices(
            y, 10, 10), 8),
    "triplet_batches_from_indices": lambda x, y, p:
        pairs.triplet_batches_from_indices(x, pairs.sample_triplet_indices(
            y, 10), 8),
    "cli --train-steps": lambda x, y, p: serve_retrieval.main(
        ["--train-steps", "5", "--gallery-size", "100"]),
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_training_slice_entry_points_raise_without_cuda(no_cuda, name):
    x, y, p = _tiny_pairs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _ENTRY_POINTS[name](x, y, p)


def _run_smoke(cwd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_cuda():
    res = _run_smoke(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
