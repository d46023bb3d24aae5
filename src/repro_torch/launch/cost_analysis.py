"""Whole-step account: FLOPs by dtype, HBM bytes, peak live bytes, ops;
the roofline terms (counterpart of ``repro/launch/hlo_analysis.py``).

The reference compiles each step to optimized HLO and parses its text,
because ``cost_analysis()`` has no collective traffic and counts a
``while`` body once. The port compiles no HLO, so there is no text to
parse and no loop to correct: eager PyTorch runs every op of every
layer and every chunk through the dispatcher, and ``CostMode`` (a
``TorchDispatchMode``) sees each one. Run over ``meta`` tensors it
counts a step at full size with no storage and nothing launched; in
``launch/mesh.fake_world`` it counts one rank's program on a production
mesh, collectives included (on one card there are none).

Counting rules, per aten op (after autograd and composite ops are
decomposed, as the card would run them eagerly):

* **FLOPs**: matrix products only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``), 2 x output elements x the
  contraction, keyed by the first operand's dtype. Elementwise ops and
  reductions are not FLOPs here (they are counted as bytes), as the
  reference counts ``dot`` only. A masked product counts whole: the
  plain attention computes every (q, kv) tile of the T x S scores and
  masks it, so its FLOPs are the full T x S product, where the card's
  flash kernel computes the causal (or windowed) tiles only.
* **Bytes** (HBM traffic, ``hlo_analysis._op_traffic_bytes``' rules):
  an op whose outputs alias its inputs (views, reshapes, expands,
  transposes, slices taken as views) moves nothing; the reader of the
  view pays for what it reads, so a slice costs its output, never its
  whole operand. A gather (``index``, ``index_select``, ``gather``,
  ``embedding``) reads and writes its output. An update in place
  (``index_put``, ``scatter``, ``index_add``, ``index_copy``,
  ``slice_scatter``, ``select_scatter``, ``copy_``) reads and writes its
  update only. Fills write their output; ``empty`` moves nothing. Every
  other op reads each tensor operand once and writes each output once
  (each operand at its own size, a view at the view's size).
* **Peak**: live bytes are the storages allocated by ops of the step,
  each added when an op first returns it and taken away when its last
  reference dies (a weak reference's callback). Arguments (parameters,
  optimizer state, inputs, caches) are counted apart. CPU tensors (0-d
  host scalars) are left out of bytes and memory.
* **Ops**: ops that are not pure aliases (what an eager run launches,
  before fusion).
* **Collectives**: every ``c10d`` and ``_c10d_functional`` op, by the
  reference's kinds (``COLLECTIVE_KINDS``): its count and its output
  bytes on this rank (the reference's convention: an all-gather's
  gathered tensor, a reduce-scatter's slot, an all-reduce's tensor),
  which are also its only HBM bytes; no FLOPs. Each is also filed under
  its link (``launch/mesh.link``: ``nvlink`` when the group's ranks lie
  in one node, ``ib`` when they span nodes) for the roofline's
  ``collective_s``.
"""

from __future__ import annotations

import gc
import weakref
from collections import defaultdict
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as mesh_lib

aten = torch.ops.aten

# the reference's kinds (repro/launch/hlo_analysis.py)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# c10d / _c10d_functional op name -> kind
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COMM_NAMESPACES = ("c10d", "_c10d_functional")


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> Dict[str, float]:
    """The three roofline terms in seconds (global work over global capacity).

    FLOPs/bytes from cost_analysis are per-partition program totals under
    SPMD, so multiply by n_chips for globals — or equivalently treat
    cost_analysis as per-chip and divide by per-chip capability. We use the
    per-chip interpretation directly.
    """
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / hbm_bw
    collective_s = collective_bytes / ici_bw
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
    }


def _mm(a, b, *_):
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_):
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _mv(a, v, *_):
    return 2.0 * a.shape[0] * a.shape[1]


def _dot(a, b, *_):
    return 2.0 * a.shape[0]


# op packet -> (index of the first product operand, FLOPs of the operands)
_PRODUCTS = {
    aten.mm: (0, _mm), aten.addmm: (1, _mm), aten.bmm: (0, _bmm),
    aten.baddbmm: (1, _bmm), aten.mv: (0, _mv), aten.addmv: (1, _mv),
    aten.dot: (0, _dot), aten.vdot: (0, _dot),
}
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
_UPDATES = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_", "index_add", "index_add_", "index_copy",
            "index_copy_", "slice_scatter", "select_scatter",
            "diagonal_scatter", "as_strided_scatter", "copy_"}
_UPDATE_ARGS = ("values", "src", "source")
_FILLS = {"fill", "fill_", "zero_", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full", "rand_like", "randn_like"}
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items, out, host: bool = False):
    """The tensors off the CPU among ``items`` (on it too when ``host``):
    tensors, and lists, tuples (NamedTuples among them) and dicts of
    them."""
    for x in items:
        if isinstance(x, torch.Tensor):
            if host or x.device.type != "cpu":
                out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out, host)
        elif isinstance(x, dict):
            _tensors(x.values(), out, host)
    return out


class CostMode(TorchDispatchMode):
    """Counts FLOPs by dtype, bytes, live bytes and ops of every aten op
    run under it (module docstring). ``add_arguments`` before entering
    registers the step's inputs."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}      # storage id -> bytes
        self._args: Dict[int, int] = {}
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.link_bytes: Dict[str, float] = defaultdict(float)

    def add_arguments(self, tree) -> int:
        """Register the storages of ``tree``'s tensors as the step's
        arguments; returns their bytes (each storage once)."""
        for t in _tensors((tree,), []):
            st = t.untyped_storage()
            self._args.setdefault(st._cdata, st.nbytes())
        return self.argument_bytes

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def new_bytes(self, tree) -> int:
        """Bytes of the storages in ``tree`` that the step allocated (its
        outputs, less what aliases an argument)."""
        seen = {}
        for t in _tensors((tree,), []):
            st = t.untyped_storage()
            if st._cdata in self._live:
                seen[st._cdata] = self._live[st._cdata]
        return sum(seen.values())

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _collective(self, func, args, kwargs, out) -> None:
        """File a c10d op under its kind and link (module docstring)."""
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is None:                     # wait_tensor, barrier, ...
            return
        outs = _tensors((out,), [], host=True)
        if not outs:                         # c10d ops mutate their inputs
            outs = _tensors((args[0],), [], host=True)
        nbytes = sum(_nbytes(t) for t in outs)
        link = mesh_lib.link(_group_ranks(func, args, kwargs))
        self.coll_bytes[kind] += nbytes
        self.coll_counts[kind] += 1
        self.link_bytes[link] += nbytes
        self.bytes += sum(_nbytes(t) for t in outs if t.device.type != "cpu")
        self.ops += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COMM_NAMESPACES:
            self._collective(func, args, kwargs, out)
            return out
        ins = _tensors((args, kwargs), [])
        outs = _tensors((out,), [])
        in_st = {t.untyped_storage()._cdata for t in ins}
        if (outs and not func._schema.is_mutable
                and all(t.untyped_storage()._cdata in in_st for t in outs)):
            return out                          # a view or alias
        self.ops += 1
        name = func._overloadpacket.__name__
        product = _PRODUCTS.get(func._overloadpacket)
        if product is not None:
            first, flops = product
            a = args[first]
            self.flops[str(a.dtype).replace("torch.", "")] += flops(
                *args[first:])
        if name in _EMPTY:
            pass
        elif name in _UPDATES:
            upd = [kwargs.get(a.name, args[i] if i < len(args) else None)
                   for i, a in enumerate(func._schema.arguments)
                   if a.name in _UPDATE_ARGS]
            upd = [t for t in upd if isinstance(t, torch.Tensor)]
            self.bytes += 2 * sum(_nbytes(t) for t in upd)
        elif name in _GATHERS:
            self.bytes += 2 * sum(_nbytes(t) for t in outs)
        elif name in _FILLS:
            self.bytes += sum(_nbytes(t) for t in outs)
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def __enter__(self):
        gc.collect()          # frees come from reference counts only
        self._gc = gc.isenabled()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._gc:
                gc.enable()

    def collectives(self) -> dict:
        """The reference's record of the collectives: bytes and counts by
        kind, their total; and the bytes by link."""
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": float(sum(self.coll_bytes.values())),
                "by_link": dict(self.link_bytes)}

    def summary(self) -> dict:
        return {"flops": float(sum(self.flops.values())),
                "flops_by_dtype": dict(self.flops),
                "hbm_bytes": float(self.bytes), "peak_bytes": self.peak,
                "ops": self.ops, "collectives": self.collectives()}


def _group_ranks(func, args, kwargs):
    """The global ranks of a collective's group: the ``process_group``
    argument of a c10d op, the ``group_name`` of a functional one (the
    world when neither is given)."""
    for i, a in enumerate(func._schema.arguments):
        v = kwargs.get(a.name, args[i] if i < len(args) else None)
        if a.name == "process_group" and isinstance(v, torch.ScriptObject):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(v))
        if a.name == "group_name" and isinstance(v, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return dist.get_process_group_ranks(_resolve_process_group(v))
    return range(dist.get_world_size())


def collective_seconds(by_link: Dict[str, float]) -> float:
    """The collectives' bytes at their links' rates, summed."""
    return sum(b / mesh_lib.LINK_BW[link] for link, b in by_link.items())


def compute_seconds(flops_by_dtype: Dict[str, float], rates) -> float:
    """Each dtype's FLOPs at its rate (``rates``: dtype name -> FLOP/s)."""
    return sum(f / rates[d] for d, f in flops_by_dtype.items())
