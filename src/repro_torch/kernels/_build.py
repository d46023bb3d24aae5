"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with nvcc into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <source>

``build/`` sits at the repository root and is git-ignored. The file name
carries a hash of the source and of every header it includes with
``#include "..."`` (followed recursively), so an edited source or shared
header (``kernels/csrc/*.cuh``) rebuilds and an unchanged one loads what
is there. A failed build raises with nvcc's
stderr; nothing falls back. Callers pass every pointer and the stream
as ``ctypes.c_void_p`` (a bare Python int would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas' per-kernel report (registers, shared memory, spills) of the
# builds this process ran, by library name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources_of(source: Path) -> list:
    """``source`` and the files it includes with quotes, recursively,
    each once, in the order first met."""
    seen, order, todo = set(), [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        order.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.exists():
                todo.append(dep)
    return order


def _target(source: Path) -> Path:
    h = hashlib.sha256()
    for path in _sources_of(source):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path, target: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.tmp, proc.target, proc.source = tmp, target, source
    return proc


def _finish(proc: subprocess.Popen) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {proc.source} "
                           f"(exit {proc.returncode}):\n{err}{out}")
    os.replace(proc.tmp, proc.target)       # atomic: readers never see half
    build_logs[proc.source.stem] = err


def build(sources: Iterable[Path]) -> Dict[str, Path]:
    """Compile every stale source, all nvcc processes started together.
    Returns name -> shared-library path."""
    targets = {Path(s).stem: _target(Path(s)) for s in sources}
    procs = [_start(Path(s), targets[Path(s).stem]) for s in sources
             if not targets[Path(s).stem].exists()]
    try:
        for p in procs:
            _finish(p)
    finally:
        for p in procs:                     # stop every process started
            if p.poll() is None:
                p.kill()
                p.wait()
    return targets


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of one ``.cu`` source, built first if stale."""
    source = Path(source)
    lib = _loaded.get(source.stem)
    if lib is None:
        path = build([source])[source.stem]
        lib = _loaded[source.stem] = ctypes.CDLL(str(path))
    return lib


def all_sources() -> list:
    """Every CUDA source of the port (one library each)."""
    pkg = Path(__file__).resolve().parent
    return sorted(pkg.glob("*/csrc/*.cu"))
