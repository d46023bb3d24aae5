"""Mutable gallery index: streaming upserts/deletes over a frozen base.

Counterpart of ``repro/serve/mutable.py`` on one device. ``ExactIndex``,
``IVFIndex`` and ``IVFPQIndex`` are build-once; ``MutableIndex`` wraps one
of them with the classic LSM split:

  base        the frozen index, untouched by mutations;
  delta       an append-only buffer of *pre-projected* new rows on the
              index's device, scanned exactly (it stays small between
              compactions);
  tombstones  dead slots — deleted rows, and rows superseded by an upsert
              of the same external id. Masked at merge time, never
              eagerly rewritten into the base.

External ids are stable across every mutation and compaction: the id->slot
map (host, control-plane state) tracks where each id lives ("base" slot or
"delta" slot), and ``topk`` returns external ids. Every mutation *batch*
bumps ``version``, so the engine's hot-query LRU flushes.

Query path: the base oversampled past its dead slots (k_top + #dead base
slots, clamped to the base's candidate pool), the delta buffer scanned by
``metric_topk`` (the hand-written kernel on the card, its plain version on
the CPU), then one (distance, external id) merge on the index's device
(``_dispatch.sort_by_distance_id``). Dead and invalid candidates become
``+inf`` with id -1. No rebuild ever happens on the query path.

Compaction folds the delta into the base and drops tombstones, with every
projected row staying on the device (gathers and slot writes are device
indexing; only ids, masks and the IVF placement walk the host):

  exact base  live base rows + live delta rows in ascending-external-id
              order wrapped by a fresh ExactIndex (no re-projection);
  IVF base    delta rows land in their nearest centroid's capacity
              headroom; if the live delta outgrows the free capacity the
              fold *spills* into a full rebuild (fresh k-means);
  IVFPQ base  the same fold, each folded row encoded against the existing
              codebooks; a spill rebuild re-trains k-means and codebooks.

``swap_metric`` re-projects the retained raw rows (``retain_raw=True``,
kept in host memory) under a fresh L, block by block on the device, and
swaps a replacement base in. Mutations must be serialized with in-flight
``topk`` calls by the caller (the engine/batcher stack issues queries from
one worker thread). A sharded base is not wrappable.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import host_array, resolve_device
from repro_torch.kernels._dispatch import BIG, sort_by_distance_id
from repro_torch.kernels.metric_topk import metric_topk, project_gallery
from repro_torch.serve import scan
from repro_torch.serve.index import ExactIndex
from repro_torch.serve.ivf import _ROW_BLOCK, IVFIndex, StepClock
from repro_torch.serve.pq import IVFPQIndex, _t_term

_DELTA_MIN_CAP = 256    # delta buffer floor; grows by doubling, so the
                        # delta scan sees O(log growth) distinct shapes


def _delta_cap(n: int) -> int:
    """Rows of the delta buffer that holds ``n`` rows."""
    return _DELTA_MIN_CAP if n <= _DELTA_MIN_CAP else 1 << (n - 1).bit_length()


def _slot_map(kind: str, ids: np.ndarray, slots: np.ndarray) -> dict:
    """{external id: (kind, slot)} — the host id map's entries."""
    return dict(zip(ids.tolist(), zip(itertools.repeat(kind),
                                       slots.tolist())))


class _Layout(NamedTuple):
    """The live rows in ascending-external-id order: output row
    ``base_dst[j]`` is base position ``base_pos[j]``, output row
    ``delta_dst[j]`` is delta slot ``delta_slot[j]``."""

    ids: np.ndarray
    base_dst: np.ndarray
    base_pos: np.ndarray
    delta_dst: np.ndarray
    delta_slot: np.ndarray


def _gather(base_rows, delta_rows, lay: _Layout, row_of=None):
    """The live rows of (base, delta) in ``lay``'s order, on ``base_rows``'
    device (numpy arrays stay numpy). ``row_of`` maps a base position to
    its row of ``base_rows`` (the IVF segments). When the layout keeps
    every base row in place and adds none, ``base_rows`` itself comes
    back (indexes never write their arrays in place). Otherwise the rows
    are copied in blocks, straight into ``out`` where a block's
    destinations are contiguous (as the base's are when new ids exceed
    the old ones), so no full-size temporary exists."""
    src = lay.base_pos if row_of is None else row_of[lay.base_pos]
    n = len(lay.ids)
    if n == len(src) == base_rows.shape[0] and \
            np.array_equal(src, np.arange(n)):
        return base_rows
    if isinstance(base_rows, np.ndarray):
        out = np.empty((n,) + base_rows.shape[1:], base_rows.dtype)
        idx = lambda a: a                                   # noqa: E731
        # mode="clip": the default "raise" buffers ``out`` (a second copy);
        # the layout's indices are in range by construction
        take = lambda rows, i, dst: np.take(  # noqa: E731
            rows, i, axis=0, out=dst, mode="clip")
    else:
        out = base_rows.new_empty((n,) + tuple(base_rows.shape[1:]))
        idx = lambda a: torch.from_numpy(a).to(out.device)  # noqa: E731
        take = lambda rows, i, dst: torch.index_select(  # noqa: E731
            rows, 0, i, out=dst)
        delta_rows = delta_rows.to(out.device)
    for rows, dst, src in ((base_rows, lay.base_dst, src),
                           (delta_rows, lay.delta_dst, lay.delta_slot)):
        for s in range(0, len(dst), _ROW_BLOCK):
            d, i = dst[s:s + _ROW_BLOCK], idx(src[s:s + _ROW_BLOCK])
            if d[-1] - d[0] == len(d) - 1:                  # contiguous
                take(rows, i, out[d[0]:d[-1] + 1])
            else:
                out[idx(d)] = rows[i]
    return out


class _DeviceState(NamedTuple):
    """Device mirrors of the host masks, rebuilt once per version."""

    n_dead_base: int
    dead_base: torch.Tensor         # (M,) bool
    base_ids: torch.Tensor          # (M,) int64 external ids
    delta_gn: torch.Tensor          # (cap,) norms; BIG on pad / dead slots
    delta_slots: torch.Tensor       # (cap,) int64 slot; -1 on pad / dead
    delta_ids: torch.Tensor         # (n,) int64 external ids


class MutableIndex:
    """MetricIndex wrapper adding upsert/delete/compact/hot-swap."""

    def __init__(self, base, L, *, ids=None, raw=None, base_kwargs=None,
                 auto_compact_delta: float = 0.5,
                 auto_compact_dead: float = 0.25):
        if base.n_shards > 1:
            raise NotImplementedError(
                "MutableIndex wraps single-shard bases only (multi-host "
                "gallery mutation is a ROADMAP item)")
        if not isinstance(base, (ExactIndex, IVFIndex, IVFPQIndex)):
            raise TypeError(f"unsupported base index {type(base).__name__}")
        if isinstance(base, IVFPQIndex) and base.rerank_depth < 1:
            # the (distance, id) merge against the exact delta scan is
            # only sound when the base returns exact distances too
            raise ValueError(
                "MutableIndex over an IVFPQ base requires rerank_depth "
                ">= 1 (exact base distances for the delta merge)")
        M = base.size
        self.base = base
        scan.check_metric_factor(L)
        self.L = torch.as_tensor(L, dtype=torch.float32).to(
            base.device).contiguous()
        self.base_ids = (np.arange(M, dtype=np.int64) if ids is None
                         else host_array(ids, np.int64).copy())
        if self.base_ids.shape != (M,):
            raise ValueError(f"ids shape {self.base_ids.shape} != ({M},)")
        if len(np.unique(self.base_ids)) != M:
            raise ValueError("external ids must be unique")
        self.raw_base: Optional[np.ndarray] = None
        self.raw_delta: Optional[np.ndarray] = None
        if raw is not None:
            # rows from a device tensor arrive as a fresh host array;
            # host rows are copied, so the caller's array is never aliased
            fresh = torch.is_tensor(raw) and raw.device.type != "cpu"
            raw = host_array(raw, np.float32)
            if raw.shape[0] != M:
                raise ValueError(f"raw rows {raw.shape[0]} != base size {M}")
            self.raw_base = raw if fresh else raw.copy()
            self.raw_delta = np.zeros((0, raw.shape[1]), np.float32)
        self._reset_delta()
        self._next_id = int(self.base_ids.max()) + 1 if M else 0
        self.auto_compact_delta = auto_compact_delta
        self.auto_compact_dead = auto_compact_dead
        # forwarded to the base's (re)builds and written into snapshot
        # manifests: plain values only, never a device or a tensor
        self._base_kwargs = dict(base_kwargs or {})
        self.version = base.version
        self.n_upserts = 0
        self.n_deletes = 0
        self.n_compactions = 0
        self.n_rebuilds = 0          # compactions that fell back to k-means
        self.n_swaps = 0
        # obs hook: the engine points this at its MetricsRegistry on
        # adoption; lifecycle transitions then land as events + counters
        self.registry = None

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, L, gallery, *, base: str = "exact", ids=None,
              retain_raw: bool = False, auto_compact_delta: float = 0.5,
              auto_compact_dead: float = 0.25, device=None, **base_kwargs):
        """Build the base index on ``device`` (the card by default) and
        wrap it.

        ``base``: "exact", "ivf" or "ivfpq" (``base_kwargs`` forward to
        the base build — n_clusters, nprobe, cap_factor, n_subspaces,
        ...). ``ids`` assigns external ids to the initial rows (default
        0..M-1). ``retain_raw=True`` keeps the raw feature rows in host
        memory so ``swap_metric`` can re-project under a fresh L.
        """
        dev = resolve_device(device)
        builders = {"exact": ExactIndex.build, "ivf": IVFIndex.build,
                    "ivfpq": IVFPQIndex.build}
        if base not in builders:
            raise ValueError(f"unknown base {base!r} (exact|ivf|ivfpq)")
        b = builders[base](L, gallery, device=dev, **base_kwargs)
        return cls(b, L, ids=ids,
                   raw=gallery if retain_raw else None,
                   base_kwargs=base_kwargs,
                   auto_compact_delta=auto_compact_delta,
                   auto_compact_dead=auto_compact_dead)

    # -- MetricIndex surface -------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def size(self) -> int:
        """Live rows (upserts minus deletes); what k_top is bounded by."""
        return len(self._loc)

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def delta_gp(self) -> torch.Tensor:
        """(n, d_out) projected delta rows, dead ones included."""
        return self._delta_gp[:len(self.delta_ids)]

    @property
    def delta_gn(self) -> torch.Tensor:
        """(n,) norms of ``delta_gp``."""
        return self._delta_gn[:len(self.delta_ids)]

    @property
    def delta_rows(self) -> int:
        """Live rows currently served from the delta buffer."""
        return int((~self.dead_delta).sum())

    @property
    def code_bytes_per_row(self):
        """Forwarded from an IVFPQ base (None otherwise)."""
        return getattr(self.base, "code_bytes_per_row", None)

    @property
    def compression_ratio(self):
        """Forwarded from an IVFPQ base (None otherwise)."""
        return getattr(self.base, "compression_ratio", None)

    @property
    def scan_impl(self):
        """Forwarded from an IVF/IVFPQ base (None for exact)."""
        return getattr(self.base, "scan_impl", None)

    @property
    def tombstones(self) -> int:
        """Dead slots awaiting compaction (base + delta)."""
        return int(self.dead_base.sum() + self.dead_delta.sum())

    def live_ids(self) -> np.ndarray:
        """Ascending external ids of every live row ((size,) int64)."""
        return np.sort(np.fromiter(self._loc, np.int64, len(self._loc)))

    def contains(self, ext_id: int) -> bool:
        return int(ext_id) in self._loc

    def topk(self, queries, k_top: int, **kw):
        """(dists (Nq, k_top) f32 ascending, external ids (Nq, k_top)
        int64), both on the index's device.

        Extra kwargs (``nprobe``, ``rerank``, ``scan_impl``) forward to
        the base.
        """
        if k_top < 1:
            raise ValueError(f"k_top must be >= 1, got {k_top}")
        if k_top > self.size:
            raise ValueError(f"k_top={k_top} > live gallery size "
                             f"{self.size}")
        if isinstance(self.base, IVFPQIndex) and kw.get("rerank") == 0:
            raise ValueError(
                "rerank=0 is unsupported through MutableIndex (the "
                "(distance, id) delta merge needs exact base distances)")
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        if q.dim() != 2:
            raise ValueError(f"queries must be (Nq, d), got "
                             f"{tuple(q.shape)}")
        st = self._device_state()
        inf = torch.tensor(float("inf"), device=self.device)
        none = torch.tensor(-1, dtype=torch.int64, device=self.device)
        parts_d, parts_i = [], []

        k_base = min(self.base.size, k_top + st.n_dead_base)
        pool = self._base_pool(kw)
        if pool is not None:
            k_base = min(k_base, pool)
        if k_base > 0:
            d_b, i_b = self.base.topk(q, k_base, **kw)
            valid = i_b >= 0                 # IVF under-filled probes: -1
            safe = torch.clamp_min(i_b, 0).long()
            dead = st.dead_base[safe] | ~valid
            parts_d.append(torch.where(dead, inf, d_b))
            parts_i.append(torch.where(dead, none, st.base_ids[safe]))

        n = len(self.delta_ids)
        if n:
            kk = min(k_top, _delta_cap(n))
            d_d, pos = metric_topk(self.L, q, self._delta_gp, st.delta_gn,
                                   k_top=kk)
            slot = st.delta_slots[pos.long()]
            valid = slot >= 0                # pad / tombstoned slots
            parts_d.append(torch.where(valid, d_d, inf))
            parts_i.append(torch.where(
                valid, st.delta_ids[torch.clamp_min(slot, 0)], none))

        dists, ids = sort_by_distance_id(torch.cat(parts_d, dim=1),
                                         torch.cat(parts_i, dim=1))
        return dists[:, :k_top], ids[:, :k_top]

    def _base_pool(self, kw) -> Optional[int]:
        """Candidate pool the base can actually return (IVF/IVFPQ:
        nprobe*cap). Oversampling past it would make the base raise;
        clamping instead costs only the (already approximate) recall of
        dead-slot oversamples."""
        if isinstance(self.base, (IVFIndex, IVFPQIndex)):
            np_ = kw.get("nprobe")
            if np_ is not None and np_ < 1:
                # a 0 pool would silently skip the base scan before the
                # base's own nprobe validation can fire
                raise ValueError(f"nprobe must be >= 1, got {np_}")
            np_ = self.base.nprobe if np_ is None else np_
            return min(np_, self.base.n_clusters) * self.base.cap
        return None

    def _device_state(self) -> _DeviceState:
        """The masks and ids the query path reads, on the index's device:
        tombstoned and pad delta slots carry gn = +BIG and slot -1 (the
        IVF segments' convention), so they surface only when fewer than
        kk live delta rows exist, and are masked then."""
        if self._dev_state is not None:
            return self._dev_state
        dev, n = self.device, len(self.delta_ids)
        cap = self._delta_gp.shape[0]
        dead_d = torch.ones(cap, dtype=torch.bool)
        dead_d[:n] = torch.from_numpy(self.dead_delta)
        dead_d = dead_d.to(dev)
        self._dev_state = _DeviceState(
            n_dead_base=int(self.dead_base.sum()),
            dead_base=torch.from_numpy(self.dead_base).to(dev),
            base_ids=torch.from_numpy(self.base_ids).to(dev),
            delta_gn=torch.where(dead_d, torch.tensor(BIG, device=dev),
                                 self._delta_gn),
            delta_slots=torch.where(
                dead_d, torch.tensor(-1, device=dev),
                torch.arange(cap, device=dev)),
            delta_ids=torch.from_numpy(self.delta_ids).to(dev))
        return self._dev_state

    # -- mutation ------------------------------------------------------------

    def upsert(self, rows, ids=None) -> np.ndarray:
        """Insert or replace rows; returns the external ids (n,) int64.

        ``rows`` (n, d) raw feature rows (numpy or a tensor; projected
        through L on the index's device, once). ``ids=None`` auto-assigns
        fresh ids; an existing id tombstones its old slot and re-lands in
        the delta (last write wins, also within a batch). One call = one
        version bump = one engine cache flush.
        """
        rows = torch.as_tensor(rows, dtype=torch.float32)
        if rows.dim() == 1:
            rows = rows[None, :]
        n = rows.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + n,
                            dtype=np.int64)
        ids = np.atleast_1d(host_array(ids, np.int64))
        if ids.shape != (n,):
            raise ValueError(f"ids shape {ids.shape} != ({n},)")
        if (ids < 0).any():
            raise ValueError("external ids must be >= 0 (negative ids are "
                             "sentinels)")
        if n == 0:
            return ids
        gp, gn = project_gallery(self.L, rows.to(self.device))
        start = len(self.delta_ids)
        self._grow_delta(start + n)
        self._delta_gp[start:start + n] = gp
        self._delta_gn[start:start + n] = gn
        self.delta_ids = np.concatenate([self.delta_ids, ids])
        self.dead_delta = np.concatenate([self.dead_delta,
                                          np.zeros(n, bool)])
        if self.raw_base is not None:
            self.raw_delta = np.concatenate([self.raw_delta,
                                             host_array(rows, np.float32)])
        for j, e in enumerate(ids.tolist()):
            old = self._loc.get(e)
            if old is not None:
                self._kill(old)
            self._loc[e] = ("delta", start + j)
        self._next_id = max(self._next_id, int(ids.max()) + 1)
        self.n_upserts += n
        self._bump()
        self._maybe_compact()
        return ids

    def _grow_delta(self, n: int):
        """Double the delta buffer until it holds ``n`` rows (new rows
        zero; the scan masks them by slot)."""
        cap, old = _delta_cap(n), self._delta_gp.shape[0]
        if cap <= old:
            return
        gp = self._delta_gp.new_zeros((cap, self._delta_gp.shape[1]))
        gn = self._delta_gn.new_zeros((cap,))
        gp[:old] = self._delta_gp
        gn[:old] = self._delta_gn
        self._delta_gp, self._delta_gn = gp, gn

    def delete(self, ids) -> None:
        """Tombstone rows by external id. Unknown ids raise KeyError (and
        the batch is rejected whole); one call = one version bump."""
        ids = np.atleast_1d(host_array(ids, np.int64))
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate ids in delete batch")
        missing = [int(e) for e in ids.tolist() if e not in self._loc]
        if missing:
            raise KeyError(f"ids not in index: {missing[:5]}"
                           f"{'...' if len(missing) > 5 else ''}")
        for e in ids.tolist():
            self._kill(self._loc.pop(int(e)))
        self.n_deletes += len(ids)
        self._bump()
        self._maybe_compact()

    def _kill(self, loc):
        kind, i = loc
        if kind == "base":
            self.dead_base[i] = True
        else:
            self.dead_delta[i] = True

    def _bump(self):
        self.version += 1           # engine LRU flushes on the next search
        self._dev_state = None

    def _maybe_compact(self):
        ref = max(self.base.size, 1)
        if ((self.auto_compact_delta
             and self.delta_rows > self.auto_compact_delta * ref)
                or (self.auto_compact_dead
                    and self.tombstones > self.auto_compact_dead * ref)):
            self.compact()

    # -- compaction ----------------------------------------------------------

    def _live_layout(self) -> _Layout:
        """Where each live row comes from, in ascending-external-id order
        — the canonical layout a from-scratch rebuild over live rows would
        use, so positional tie-breaks keep matching external-id ones."""
        lb = np.flatnonzero(~self.dead_base)
        ld = np.flatnonzero(~self.dead_delta)
        ids = np.concatenate([self.base_ids[lb], self.delta_ids[ld]])
        order = np.argsort(ids)
        from_base = order < len(lb)
        base_dst = np.flatnonzero(from_base)
        delta_dst = np.flatnonzero(~from_base)
        return _Layout(ids[order], base_dst, lb[order[base_dst]], delta_dst,
                       ld[order[delta_dst] - len(lb)])

    def _live_state(self, lay: Optional[_Layout] = None):
        """Live (gp, gn) on the index's device, ids, raw (host or None), in
        ascending-external-id order. The base rows are gathered where they
        live: ExactIndex ``gp``, the IVFPQ rerank store, or the IVF
        segments through their position -> slot map."""
        lay = self._live_layout() if lay is None else lay
        base, row_of = self.base, None
        if isinstance(base, ExactIndex):
            rows, norms = base.gp, base.gn
        elif isinstance(base, IVFPQIndex):
            # exact rows in base-position order; codes are never decoded
            rows, norms = base.gp_full, base.gn_full
        else:
            ids_pad = base.ids_pad.cpu().numpy()
            occ = np.flatnonzero(ids_pad >= 0)
            row_of = np.empty(base.size, np.int64)
            row_of[ids_pad[occ]] = occ
            rows, norms = base.gp_pad, base.gn_pad
        gp = _gather(rows, self.delta_gp, lay, row_of).to(self.device)
        gn = _gather(norms, self.delta_gn, lay, row_of).to(self.device)
        raw = (None if self.raw_base is None
               else _gather(self.raw_base, self.raw_delta, lay))
        return gp, gn, lay.ids, raw

    def compact(self) -> bool:
        """Fold the delta into the base and drop tombstones.

        Exact base: gather + re-wrap (no re-projection). IVF base: delta
        rows land in nearest-centroid capacity headroom; if the live delta
        exceeds the total free capacity the fold spills and triggers a
        full rebuild (fresh k-means). IVFPQ base: the same fold, each
        folded row *encoded* with the existing residual codebooks (a
        spill rebuild re-trains both). Returns True if anything changed.
        """
        if self.delta_rows == 0 and self.tombstones == 0:
            return False
        folded, dropped = self.delta_rows, self.tombstones
        rebuilds_before = self.n_rebuilds
        if isinstance(self.base, IVFPQIndex):
            self._compact_ivfpq()
        elif isinstance(self.base, IVFIndex):
            self._compact_ivf()
        else:
            self._compact_exact()
        self.n_compactions += 1
        self._event("compaction", base=type(self.base).__name__,
                    delta_rows=folded, tombstones=dropped,
                    spill_rebuild=self.n_rebuilds > rebuilds_before,
                    size=self.base.size)
        self._reset_delta()
        self._bump()
        return True

    def _event(self, name: str, **attrs) -> None:
        """Structured lifecycle event onto the adopting engine's registry
        (no-op while unadopted)."""
        if self.registry is not None:
            self.registry.event(f"index_{name}", **attrs)
            self.registry.counter(
                "index_lifecycle_total",
                "mutable-index lifecycle transitions by kind",
                labelnames=("event",)).inc(event=name)

    def _reset_delta(self):
        """Empty delta and tombstones over the current base; the buffer is
        sized off the *current* L (a rank-changing swap_metric changes
        d_out)."""
        dev, k = self.device, self.L.shape[0]
        self._delta_gp = torch.zeros((_DELTA_MIN_CAP, k), device=dev)
        self._delta_gn = torch.zeros((_DELTA_MIN_CAP,), device=dev)
        self.delta_ids = np.zeros((0,), np.int64)
        self.dead_delta = np.zeros((0,), bool)
        self.dead_base = np.zeros(self.base.size, bool)
        if self.raw_delta is not None:
            self.raw_delta = np.zeros((0, self.raw_delta.shape[1]),
                                      np.float32)
        self._loc = _slot_map("base", self.base_ids,
                              np.arange(len(self.base_ids)))
        self._dev_state = None

    def _restore(self, *, dead_base, delta_gp, delta_gn, delta_ids,
                 dead_delta, raw_delta, next_id: int, version: int,
                 counters: dict):
        """Set the mutation state (a snapshot's or another package's)
        over the wrapped base: masks, the delta rows, the id map, the
        counters and the version."""
        self.dead_base = host_array(dead_base, bool).copy()
        self.delta_ids = host_array(delta_ids, np.int64).copy()
        self.dead_delta = host_array(dead_delta, bool).copy()
        n = len(self.delta_ids)
        self._grow_delta(n)
        self._delta_gp[:n] = torch.as_tensor(host_array(delta_gp, np.float32))
        self._delta_gn[:n] = torch.as_tensor(host_array(delta_gn, np.float32))
        if raw_delta is not None:
            self.raw_delta = host_array(raw_delta, np.float32).copy()
        lb = np.flatnonzero(~self.dead_base)
        ld = np.flatnonzero(~self.dead_delta)
        self._loc = _slot_map("base", self.base_ids[lb], lb)
        self._loc.update(_slot_map("delta", self.delta_ids[ld], ld))
        self._next_id = int(next_id)
        for name in ("n_upserts", "n_deletes", "n_compactions",
                     "n_rebuilds", "n_swaps"):
            setattr(self, name, int(counters[name]))
        self.version = int(version)
        self._dev_state = None

    def _compact_exact(self):
        gp, gn, ids, raw = self._live_state()
        self.base = ExactIndex.from_projected(self.L, gp, gn,
                                              device=self.device,
                                              backend=self.base.backend)
        self.base_ids = ids
        if raw is not None:
            self.raw_base = raw

    def _fold_segments(self, clear_dead, place_delta, rebuild, remake):
        """Shared IVF/IVFPQ compaction skeleton (the reference's).

        Steps: free dead slots, remap kept slots' ids to the new
        ascending-external-id order, spill-check the headroom (falling
        back to a full rebuild), then greedily place each live delta row
        in its nearest centroid with a free slot. The callbacks own the
        payload arrays (device tensors):

          clear_dead(dead_slots)                wipe freed slots
          place_delta(slots, clusters, rows)    write placed delta rows
          rebuild(gp, gn)                       spill path: rebuild
                                                self.base from live rows
          remake(ids_pad, lay)                  construct the folded base
        """
        base, dev = self.base, self.device
        C, cap = base.n_clusters, base.cap
        live_d = np.flatnonzero(~self.dead_delta)
        lb = ~self.dead_base
        lay = self._live_layout()
        new_ids = lay.ids

        ids_pad = base.ids_pad.cpu().numpy().copy()
        occ_slots = np.flatnonzero(ids_pad >= 0)
        old_pos = ids_pad[occ_slots]
        keep = lb[old_pos]
        dead_slots = occ_slots[~keep]
        clear_dead(torch.from_numpy(dead_slots).to(dev))
        ids_pad[dead_slots] = -1
        kept_slots = occ_slots[keep]
        ids_pad[kept_slots] = np.searchsorted(
            new_ids, self.base_ids[old_pos[keep]]).astype(np.int32)

        n_free = C * cap - len(kept_slots)
        if n_free < len(live_d):            # headroom spill -> full rebuild
            gp, gn, ids, raw = self._live_state(lay)
            rebuild(gp, gn)
            self.base_ids = ids
            if raw is not None:
                self.raw_base = raw
            self.n_rebuilds += 1
            self._event("spill_rebuild", free_slots=int(n_free),
                        live_delta=int(len(live_d)))
            return

        # in-place fold: each delta row takes a free slot in its nearest
        # centroid (spilling to the next-nearest with space); the distance
        # matrix is the reference's numpy f32 formula, so the slots are
        # the reference's
        free = [list(np.flatnonzero(ids_pad[c * cap:(c + 1) * cap] == -1))
                for c in range(C)]
        cent = base.centroids.cpu().numpy()
        dgp = self.delta_gp[torch.from_numpy(live_d).to(dev)].cpu().numpy()
        d_dc = (np.sum(dgp ** 2, axis=1)[:, None]
                + np.sum(cent ** 2, axis=1)[None, :]
                - 2.0 * dgp @ cent.T)                       # (live, C)
        slots = np.empty(len(live_d), np.int64)
        clusters = np.empty(len(live_d), np.int64)
        for i in range(len(live_d)):
            for c in np.argsort(d_dc[i]):
                if free[c]:
                    slots[i] = c * cap + free[c].pop(0)
                    clusters[i] = c
                    break
        place_delta(*(torch.from_numpy(a).to(dev)
                      for a in (slots, clusters, live_d)))
        ids_pad[slots] = np.searchsorted(
            new_ids, self.delta_ids[live_d]).astype(np.int32)
        if self.raw_base is not None:
            self.raw_base = _gather(self.raw_base, self.raw_delta, lay)
        # remake returns a fresh base instance: the old one stays valid
        # for whoever still holds it
        remake(torch.from_numpy(ids_pad).to(dev), lay)
        self.base_ids = new_ids

    def _rebuild_kwargs(self):
        kw = {k: v for k, v in self._base_kwargs.items()
              if k in ("iters", "seed", "cap_factor")}
        return dict(kw, device=self.device)

    def _compact_ivf(self):
        """IVF fold: delta rows land full-precision in nearest-centroid
        capacity headroom (see ``_fold_segments``)."""
        base = self.base
        gp_pad = base.gp_pad.clone()
        gn_pad = base.gn_pad.clone()

        def clear_dead(dead_slots):
            gp_pad[dead_slots] = 0.0
            gn_pad[dead_slots] = BIG

        def place_delta(slots, clusters, rows):
            gp_pad[slots] = self.delta_gp[rows]
            gn_pad[slots] = self.delta_gn[rows]

        def rebuild(gp, gn):
            self.base = IVFIndex.build_projected(
                self.L, gp, gn, n_clusters=base.n_clusters,
                nprobe=base.nprobe, scan_impl=base.scan_impl,
                **self._rebuild_kwargs())

        def remake(ids_pad, lay):
            self.base = IVFIndex(
                L=base.L, centroids=base.centroids, gp_pad=gp_pad,
                gn_pad=gn_pad, ids_pad=ids_pad, cap=base.cap,
                n_clusters=base.n_clusters, nprobe=base.nprobe,
                n_rows=len(lay.ids), block_q=base.block_q,
                scan_impl=base.scan_impl)

        self._fold_segments(clear_dead, place_delta, rebuild, remake)

    def _compact_ivfpq(self):
        """IVFPQ fold: each placed delta row is encoded against the
        *existing* codebooks (one batched encode per compaction) and the
        full-precision store is gathered in external-id order where it
        lives; a headroom spill rebuilds k-means *and* codebooks."""
        base = self.base
        codes_pad = base.codes_pad.clone()
        t_pad = base.t_pad.clone()

        def clear_dead(dead_slots):
            codes_pad[dead_slots] = 0
            t_pad[dead_slots] = BIG

        def place_delta(slots, clusters, rows):
            if not len(rows):
                return
            cent = base.centroids[clusters]
            codes = base.pq.encode(self.delta_gp[rows] - cent)
            codes_pad[slots] = codes
            t_pad[slots] = _t_term(base.pq, codes, cent)

        def rebuild(gp, gn):
            self.base = IVFPQIndex.build_projected(
                self.L, gp, gn, n_clusters=base.n_clusters,
                nprobe=base.nprobe, n_subspaces=base.pq.n_subspaces,
                bits=base.pq.bits, rerank_depth=base.rerank_depth,
                store=base.store, scan_impl=base.scan_impl,
                **self._rebuild_kwargs())

        def remake(ids_pad, lay):
            self.base = IVFPQIndex(
                L=base.L, centroids=base.centroids, pq=base.pq,
                codes_pad=codes_pad, t_pad=t_pad, ids_pad=ids_pad,
                gp_full=_gather(base.gp_full, self.delta_gp, lay),
                gn_full=_gather(base.gn_full, self.delta_gn, lay),
                cap=base.cap, n_clusters=base.n_clusters,
                nprobe=base.nprobe, n_rows=len(lay.ids),
                rerank_depth=base.rerank_depth, store=base.store,
                scan_impl=base.scan_impl, block_q=base.block_q)

        self._fold_segments(clear_dead, place_delta, rebuild, remake)

    # -- metric hot-swap -----------------------------------------------------

    def swap_metric(self, L_new, block_rows: int = 65536,
                    timings: Optional[dict] = None) -> None:
        """Re-project the live gallery under a fresh metric factor and swap.

        Requires ``retain_raw=True`` at build. The live raw rows (base +
        delta, tombstones dropped, ascending-external-id order) go to the
        device in ``block_rows`` blocks and are projected there; a
        replacement base builds off to the side, and served state is first
        touched by the final flip. One version bump flushes the engine
        cache. ``L_new`` may have a different rank (d_out); only d_in must
        match the raw rows. ``timings``, when given, receives the seconds
        of "host_to_device", "project" and "rebuild", each ended by a
        device synchronisation.
        """
        if self.raw_base is None:
            raise ValueError("swap_metric requires retain_raw=True at "
                             "build (raw features were not kept)")
        scan.check_metric_factor(L_new, self.raw_base.shape[1],
                                 what="L_new")
        dev = self.device
        L_new = torch.as_tensor(L_new, dtype=torch.float32).to(
            dev).contiguous()
        lay = self._live_layout()
        raw = _gather(self.raw_base, self.raw_delta, lay)
        n = raw.shape[0]
        clock = StepClock(dev, timings)
        gp = torch.empty((n, L_new.shape[0]), device=dev)
        gn = torch.empty((n,), device=dev)
        for s in range(0, n, block_rows):
            x = torch.from_numpy(raw[s:s + block_rows]).to(dev)
            clock.lap("host_to_device")
            gp[s:s + block_rows], gn[s:s + block_rows] = \
                project_gallery(L_new, x)
            clock.lap("project")
        base = self.base
        if isinstance(base, IVFPQIndex):
            new_base = IVFPQIndex.build_projected(
                L_new, gp, gn, n_clusters=base.n_clusters,
                nprobe=base.nprobe,
                # a lower-rank L may have fewer projected dims than the
                # old code layout split over; PQ needs n_subspaces <= k
                n_subspaces=min(base.pq.n_subspaces, int(L_new.shape[0])),
                bits=base.pq.bits, rerank_depth=base.rerank_depth,
                store=base.store, scan_impl=base.scan_impl,
                **self._rebuild_kwargs())
        elif isinstance(base, IVFIndex):
            new_base = IVFIndex.build_projected(
                L_new, gp, gn, n_clusters=base.n_clusters,
                nprobe=base.nprobe, scan_impl=base.scan_impl,
                **self._rebuild_kwargs())
        else:
            new_base = ExactIndex.from_projected(L_new, gp, gn, device=dev,
                                                 backend=base.backend)
        clock.lap("rebuild")
        # the flip: nothing above mutated served state
        self.base = new_base
        self.base_ids = lay.ids
        self.raw_base = raw
        self.L = L_new
        self.n_swaps += 1
        self._event("swap_metric", base=type(new_base).__name__,
                    rows=int(n), block_rows=block_rows)
        self._reset_delta()
        self._bump()
