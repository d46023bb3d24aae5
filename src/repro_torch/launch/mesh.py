"""Meshes: named shapes, live meshes over a process group, and the
card's figures (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` is a named shape, axis name -> size, with no process group
behind it: what the sharding plan (``sharding/partition.py``) and the
dry-run account (``launch/dryrun.py``) read. A ``LiveMesh`` has the same
``shape`` / ``size`` interface over the ranks of a live
``torch.distributed`` group: this rank's coordinates and device, and one
sub-group per set of axes, which the axis collectives of
``sharding/partition.py`` run over. Ranks are laid out row-major over the
axes, as ``jax.make_mesh`` lays out devices.

``fake_world(name)`` enters a world of ``MESHES[name].size`` ranks with
no process behind any but this one (torch's ``"fake"`` backend: every
collective returns at once and moves nothing), as rank 0, with ``meta``
as the rank device, and yields the ``LiveMesh`` over it: what the dry
run traces a production mesh's per-rank program in (``launch/dryrun.py``;
rank 0 holds the largest block where a dimension does not divide).

``spawn(fn, n_ranks)`` runs ``fn`` on that many processes (the ``spawn``
start method; rendezvous through a file in a temporary directory) and
returns each rank's result; a rank that raises fails the call with its
traceback, and no call outlives its timeout. ``join`` enters a group
that ``torchrun`` started. The backend is a rule: NCCL when every rank
has a card of its own, gloo when ranks share a card (tensors stay on the
card; gloo stages them through the host) or run on the CPU.

This module is the one source of the H100's figures: the dry-run's
roofline terms and ``chip_smoke.py``'s per-kernel bounds read them from
here. The reference divides a step's collective bytes by one ICI rate;
an H100 mesh has two links, NVLink inside a node of ``NODE_RANKS`` and
InfiniBand between nodes, so ``link`` names a group's by whether its
ranks (row-major over the mesh axes) span nodes, and ``LINK_BW`` gives
its rate: the card's counterpart of the TPU figure, not a new feature.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import multiprocessing
import os
import pickle
import queue
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# NVIDIA H100 SXM5 80GB at its 700 W limit, dense rates (no sparsity),
# NVIDIA's data sheet
CARD = "H100 SXM5 80GB, 700 W"
PEAK_FLOPS_BF16 = 989e12        # bf16 / fp16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12        # TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # f32 FFMA, outside the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
HBM_BYTES = 80e9
NVLINK_BW = 450e9               # bytes/s per direction
# between nodes: one 400 Gb/s NDR InfiniBand port a GPU (a DGX H100 has
# eight ConnectX-7 ports for its eight GPUs; NVIDIA's DGX H100 user guide)
IB_BW = 50e9                    # bytes/s per direction
NODE_RANKS = 8                  # GPUs a node joins by NVLink (DGX / HGX H100)

# The rate each dtype's products run at on the port's plain paths. f32
# products are full f32 (``kernels/_dispatch.full_f32`` turns TF32 off),
# so they run at the FFMA rate; the hand-written kernels' f32 products
# are 3xTF32, PEAK_FLOPS_TF32 / 3, above it.
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": PEAK_FLOPS_BF16,
    "float16": PEAK_FLOPS_BF16,
    "float32": PEAK_FLOPS_F32,
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh shape: ``axis_names`` with ``axis_sizes``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_local_mesh(model: int = 1,
                    data: Optional[int] = None) -> Union[Mesh, "LiveMesh"]:
    """(data, model) over the ranks of the live process group (``data``
    defaults to the world size over ``model``), as the reference's spans
    the local devices; without a group, one process: the named shape
    (data=1, model=1)."""
    if not _initialized():
        if (data or 1) * model != 1:
            raise ValueError(f"a (data={data}, model={model}) mesh needs a "
                             f"process group of that many ranks "
                             f"(launch/mesh.spawn)")
        return Mesh(("data", "model"), (1, 1))
    data = data or max(1, dist.get_world_size() // model)
    return LiveMesh(("data", "model"), (data, model))


LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


def link(ranks: Sequence[int]) -> str:
    """The link a collective over the global ``ranks`` runs on:
    ``"nvlink"`` when they lie in one node of ``NODE_RANKS``, ``"ib"``
    when they span nodes (``LINK_BW`` its rate)."""
    return "nvlink" if len({int(r) // NODE_RANKS for r in ranks}) <= 1 \
        else "ib"


# The meshes the dry-run account names: the one card, and the two
# production meshes its sharding plan reads
MESHES = {"h100": Mesh(("data", "model"), (1, 1)),
          "16x16": make_production_mesh(),
          "pod2x16x16": make_production_mesh(multi_pod=True)}


# -- live meshes over torch.distributed -------------------------------------

# This process's rank device, set where the process joins its group
# (``spawn``'s ranks, ``join``); every LiveMesh takes it.
_rank_device: Optional[torch.device] = None


def rank_device() -> torch.device:
    """The device this rank was given when it joined its group."""
    if _rank_device is None:
        raise RuntimeError("this process did not join a group through "
                           "launch/mesh (spawn or join)")
    return _rank_device


def backend_for(device: torch.device, n_local_ranks: int) -> str:
    """The backend rule: NCCL when every rank of this host has a card of
    its own, gloo when ranks share a card or run on the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() >= n_local_ranks:
        return "nccl"
    return "gloo"


def _place_rank(device_type: str, backend: str, local_rank: int):
    global _rank_device
    if device_type == "cpu":
        _rank_device = torch.device("cpu")
    else:
        _rank_device = torch.device(
            "cuda", local_rank if backend == "nccl" else 0)
        torch.cuda.set_device(_rank_device)
    return _rank_device


def _log_backend(n_ranks: int, backend: str, device) -> None:
    shared = " (the ranks share the card; gloo stages through the host)" \
        if backend == "gloo" and device.type == "cuda" else ""
    print(f"mesh: {n_ranks} rank(s) over {backend} on {device}{shared}",
          file=sys.stderr, flush=True)


class LiveMesh:
    """A named mesh over the ranks of the live process group.

    Built by every rank of the group at the same point (the sub-groups
    are made collectively). ``shape`` / ``size`` read as ``Mesh``'s;
    ``coords`` is this rank's coordinate by axis, ``device`` its device.
    """

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int]):
        if not _initialized():
            raise RuntimeError("a live mesh needs a process group: start "
                               "the ranks with launch/mesh.spawn (or "
                               "torchrun and launch/mesh.join)")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        world = dist.get_world_size()
        if int(np.prod(self.axis_sizes)) != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the "
                             f"group {world}")
        self.rank = dist.get_rank()
        self.device = rank_device()
        self.backend = dist.get_backend()
        self.coords = {a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(self.rank, self.axis_sizes))}
        # a group for each set of axes spanning more than one rank and
        # less than the world (the world is the default group); every
        # rank makes every group, in one order
        self._groups = {}
        grid = np.arange(world).reshape(self.axis_sizes)
        for r in range(1, len(self.axis_names)):
            for axes in itertools.combinations(range(len(self.axis_names)),
                                               r):
                if not 1 < int(np.prod([self.axis_sizes[i]
                                        for i in axes])) < world:
                    continue
                rest = [i for i in range(len(self.axis_names))
                        if i not in axes]
                members = np.transpose(grid, rest + list(axes)).reshape(
                    int(np.prod([self.axis_sizes[i] for i in rest])), -1)
                for ranks in members.tolist():
                    group = dist.new_group(sorted(ranks))
                    if self.rank in ranks:
                        self._groups[frozenset(
                            self.axis_names[i] for i in axes)] = group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} name no distinct axes of "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple of names)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def axis_index(self, axes) -> int:
        """This rank's linear index along ``axes``, row-major in the order
        given (``jax.lax.axis_index`` over a tuple of names)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def slot_order(self, axes) -> Optional[list]:
        """The ``axis_index`` along ``axes`` (in the order given) of each
        member of their group, in the group's rank order (row-major over
        the mesh's own axis order); None when the two orders agree."""
        axes = self._axes(axes)
        mine = sorted(axes, key=self.axis_names.index)
        if list(axes) == mine:
            return None
        order = []
        for coords in itertools.product(*(range(self.shape[a])
                                          for a in mine)):
            at = dict(zip(mine, coords))
            i = 0
            for a in axes:
                i = i * self.shape[a] + at[a]
            order.append(i)
        return order

    def group(self, axes):
        """The process group along ``axes``: None when it holds this rank
        alone, the default group when it holds every rank."""
        n = self.axis_size(axes)
        if n == self.size:              # a one-rank world runs it too
            return dist.group.WORLD
        if n == 1:
            return None
        return self._groups[frozenset(self._axes(axes))]

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` from rank ``src`` on every rank (in place; returned)."""
        dist.broadcast(x, src)
        return x

    def __repr__(self) -> str:
        return (f"LiveMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, n_ranks, init_method, device_type, backend,
               timeout, args, results):
    """One spawned rank: join the group, run ``fn``, report its result (on
    the host) or its traceback."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
        # the ranks share the host's cores (idle worker threads of one
        # rank would otherwise spin on the cores another's collectives need)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
        device = _place_rank(device_type, backend, rank)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout),
            device_id=device if backend == "nccl" else None)
        if rank == 0:
            _log_backend(n_ranks, backend, device)
        # plain pickle bytes: the queue's own pickler would share tensor
        # memory through this process, which ends before it is read
        out = pickle.dumps(_to_host(fn(*args)))
        if dist.is_initialized():           # fn may have ended the group
            dist.barrier()
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                   # reported, then this rank ends
        results.put((rank, False, traceback.format_exc()))


@contextlib.contextmanager
def fake_world(mesh: Union[str, Mesh]):
    """A world of ``mesh``'s ranks (a name of ``MESHES`` or a ``Mesh``)
    over torch's ``"fake"`` backend, entered as rank 0 with ``meta`` as
    the rank device; yields the ``LiveMesh`` over it and destroys the
    group on exit. Refuses to start while a group is live."""
    if _initialized():
        raise RuntimeError("a process group is live: fake_world starts a "
                           "world of its own")
    shape = MESHES[mesh] if isinstance(mesh, str) else mesh
    # torch's fake store and backend live in its testing package, so they
    # are imported here only: every module imports on a plain torch
    from torch.testing._internal.distributed.fake_pg import FakeStore
    global _rank_device
    before = _rank_device
    dist.init_process_group("fake", rank=0, world_size=shape.size,
                            store=FakeStore())
    _rank_device = torch.device("meta")
    try:
        yield LiveMesh(shape.axis_names, shape.axis_sizes)
    finally:
        _rank_device = before
        dist.destroy_process_group()


class RankError(RuntimeError):
    """A spawned rank raised, died or outlived the call's timeout."""


def spawn(fn: Callable, n_ranks: int, device=None, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` new processes joined in one group;
    returns their results by rank (tensors moved to the host).

    ``device=None`` is the card and raises without one; ``"cpu"`` runs
    the ranks on the CPU over gloo. ``fn`` and ``args`` must pickle (a
    module-level function). ``timeout`` bounds the group's start and each
    of its collectives (a collective past it raises on its rank), and
    twice ``timeout`` the whole call: a rank that raises, dies or is
    still running then raises ``RankError`` (with the rank's traceback),
    and every rank still alive is stopped.
    """
    dev = resolve_device(device)
    backend = backend_for(dev, n_ranks)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, n_ranks, init, dev.type, backend, timeout, args,
            results)) for r in range(n_ranks)]
        # started together: a start returns only once its rank has read
        # its arguments, after importing fn's module
        starters = [threading.Thread(target=p.start) for p in procs]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        out = {}
        deadline = time.monotonic() + 2 * timeout
        try:
            while len(out) < n_ranks:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead and results.empty():
                        raise RankError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                    if time.monotonic() > deadline:
                        late = [r for r in range(n_ranks) if r not in out]
                        raise RankError(f"ranks {late} still running after "
                                        f"{2 * timeout:.0f} s")
                    continue
                if not ok:
                    raise RankError(f"rank {rank} of {n_ranks} failed:\n"
                                    f"{payload}")
                out[rank] = pickle.loads(payload)  # bytes our ranks wrote
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(n_ranks)]


def join(device=None, timeout: float = 600.0):
    """Join the group that ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR`` / ``_PORT``
    in the environment), by the same device and backend rule as
    ``spawn``. Returns this rank's device."""
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                 os.environ["WORLD_SIZE"]))
    backend = backend_for(dev, n_local)
    device = _place_rank(dev.type, backend, local)
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=timeout),
        device_id=device if backend == "nccl" else None)
    if dist.get_rank() == 0:
        _log_backend(dist.get_world_size(), backend, device)
    return device
