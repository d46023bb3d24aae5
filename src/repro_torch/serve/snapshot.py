"""Index snapshots: npz segments + a manifest, restart without re-projecting.

Counterpart of ``repro/serve/snapshot.py``, in the same format, so a
snapshot written by either package loads in the other:

  base.npz      the frozen base index arrays — ExactIndex: L, gp, gn;
                IVFIndex: L, centroids, gp_pad, gn_pad, ids_pad;
                IVFPQIndex: L, centroids, codebooks, codes_pad, t_pad,
                ids_pad plus the full-precision rerank store
                (gp_full/gn_full);
  mutable.npz   (MutableIndex only) base_ids, the tombstone masks and the
                pre-projected delta buffer;
  raw.npz       (MutableIndex with retained raw rows) raw_base, raw_delta;
  manifest.json written **last**, through a ``.tmp`` and ``os.replace`` —
                a partial snapshot has no manifest and ``load_index``
                refuses it. Format number, index type, ``version``, the L
                fingerprint (sha256 prefix of the f32 factor bytes) and
                shape, the scalar build parameters, the mutable counters.

The stored arrays are the exact f32 contents of the index's tensors, so a
loaded index on the same device answers top-k bit for bit as the saved one
did. The arrays cross to the host for the write and back to ``device``
(the card by default) on load.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.device import host_array, resolve_device
from repro_torch.serve import scan
from repro_torch.serve.index import ExactIndex
from repro_torch.serve.ivf import IVFIndex
from repro_torch.serve.mutable import MutableIndex
from repro_torch.serve.pq import IVFPQIndex, ProductQuantizer

FORMAT = 1
MANIFEST = "manifest.json"


def l_fingerprint(L) -> str:
    """Stable short id of a metric factor: sha256 of its C-contiguous f32
    bytes (the same digest the reference computes)."""
    a = np.ascontiguousarray(host_array(L, np.float32))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def has_snapshot(snapshot_dir: str) -> bool:
    """True iff ``snapshot_dir`` holds a *complete* snapshot (its manifest,
    written last, exists)."""
    return os.path.isfile(os.path.join(snapshot_dir, MANIFEST))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _base_payload(index):
    """(arrays dict, meta dict) for a frozen base index."""
    if isinstance(index, ExactIndex):
        return ({"L": _np(index.L), "gp": _np(index.gp),
                 "gn": _np(index.gn)},
                {"base_type": "exact"})
    if isinstance(index, IVFIndex):
        return ({"L": _np(index.L), "centroids": _np(index.centroids),
                 "gp_pad": _np(index.gp_pad), "gn_pad": _np(index.gn_pad),
                 "ids_pad": _np(index.ids_pad)},
                {"base_type": "ivf", "cap": index.cap,
                 "n_clusters": index.n_clusters, "nprobe": index.nprobe,
                 "n_rows": index.n_rows, "block_q": index.block_q,
                 "scan_impl": index.scan_impl})
    if isinstance(index, IVFPQIndex):
        return ({"L": _np(index.L), "centroids": _np(index.centroids),
                 "codebooks": _np(index.pq.codebooks),
                 "codes_pad": _np(index.codes_pad),
                 "t_pad": _np(index.t_pad), "ids_pad": _np(index.ids_pad),
                 "gp_full": _np(index.gp_full),
                 "gn_full": _np(index.gn_full)},
                {"base_type": "ivfpq", "cap": index.cap,
                 "n_clusters": index.n_clusters, "nprobe": index.nprobe,
                 "n_rows": index.n_rows, "block_q": index.block_q,
                 "pq_dim": index.pq.dim,
                 "rerank_depth": index.rerank_depth,
                 "store": index.store, "scan_impl": index.scan_impl})
    raise TypeError(f"cannot snapshot {type(index).__name__}")


def _load_base(path: str, meta: dict, dev: torch.device):
    with np.load(path) as z:
        a = {k: torch.from_numpy(z[k]) for k in z.files}
    L = a["L"].to(torch.float32).to(dev)
    if meta["base_type"] == "exact":
        return ExactIndex.from_projected(L, a["gp"], a["gn"], device=dev)
    # a stored knob the target device cannot serve raises, as at a build
    scan_impl = str(meta.get("scan_impl", "auto"))
    scan.resolve_scan_impl(scan_impl, device=dev)
    seg = dict(L=L, centroids=a["centroids"].to(dev),
               ids_pad=a["ids_pad"].to(torch.int32).to(dev),
               cap=int(meta["cap"]), n_clusters=int(meta["n_clusters"]),
               nprobe=int(meta["nprobe"]), n_rows=int(meta["n_rows"]),
               block_q=int(meta["block_q"]), scan_impl=scan_impl)
    if meta["base_type"] == "ivfpq":
        store = str(meta["store"])
        rows_dev = dev if store == "device" else torch.device("cpu")
        pq = ProductQuantizer(codebooks=a["codebooks"].to(dev),
                              dim=int(meta["pq_dim"]))
        return IVFPQIndex(
            pq=pq, codes_pad=a["codes_pad"].to(dev), t_pad=a["t_pad"].to(dev),
            gp_full=a["gp_full"].to(torch.float32).to(rows_dev),
            gn_full=a["gn_full"].to(torch.float32).to(rows_dev),
            rerank_depth=int(meta["rerank_depth"]), store=store, **seg)
    return IVFIndex(gp_pad=a["gp_pad"].to(dev), gn_pad=a["gn_pad"].to(dev),
                    **seg)


def save_index(index, snapshot_dir: str, *, registry=None) -> dict:
    """Persist an ExactIndex / IVFIndex / IVFPQIndex / MutableIndex (over
    any of those bases) to ``snapshot_dir``.

    Writes the npz segments first and the manifest last (re-saving
    retracts the old manifest before touching segments). Returns the
    manifest dict. ``registry`` (or the index's own adopting registry)
    gets an ``index_snapshot_save`` event.
    """
    if index.n_shards > 1:
        raise NotImplementedError(
            "snapshots cover single-shard indexes only")
    os.makedirs(snapshot_dir, exist_ok=True)
    # a crash mid-save must leave an (unloadable) incomplete snapshot, not
    # the old manifest over new partial segments
    stale = os.path.join(snapshot_dir, MANIFEST)
    if os.path.isfile(stale):
        os.remove(stale)
    mutable = isinstance(index, MutableIndex)
    base = index.base if mutable else index
    arrays, base_meta = _base_payload(base)
    np.savez(os.path.join(snapshot_dir, "base.npz"), **arrays)
    segments = {"base": "base.npz"}

    manifest = {
        "format": FORMAT,
        "type": type(index).__name__,
        "version": index.version,
        "l_fingerprint": l_fingerprint(index.L),
        "l_shape": list(index.L.shape),
        "size": index.size,
        "base": base_meta,
        "segments": segments,
    }
    if mutable:
        np.savez(os.path.join(snapshot_dir, "mutable.npz"),
                 base_ids=index.base_ids, dead_base=index.dead_base,
                 delta_gp=_np(index.delta_gp), delta_gn=_np(index.delta_gn),
                 delta_ids=index.delta_ids, dead_delta=index.dead_delta)
        segments["mutable"] = "mutable.npz"
        if index.raw_base is not None:
            np.savez(os.path.join(snapshot_dir, "raw.npz"),
                     raw_base=index.raw_base, raw_delta=index.raw_delta)
            segments["raw"] = "raw.npz"
        manifest["mutable"] = {
            "next_id": index._next_id,
            "n_upserts": index.n_upserts, "n_deletes": index.n_deletes,
            "n_compactions": index.n_compactions,
            "n_rebuilds": index.n_rebuilds, "n_swaps": index.n_swaps,
            "auto_compact_delta": index.auto_compact_delta,
            "auto_compact_dead": index.auto_compact_dead,
            "base_kwargs": index._base_kwargs,
        }

    path = os.path.join(snapshot_dir, MANIFEST)
    with open(path + ".tmp", "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(path + ".tmp", path)
    _emit(index, registry, "snapshot_save", type=manifest["type"],
          size=manifest["size"], version=manifest["version"],
          dir=snapshot_dir)
    return manifest


def _emit(index, registry, name: str, **attrs) -> None:
    """Structured obs event: the explicit registry wins, else the index's
    adopting registry (the engine attaches one to MutableIndex; frozen
    bases have none — no-op)."""
    registry = (registry if registry is not None
                else getattr(index, "registry", None))
    if registry is not None:
        registry.event(f"index_{name}", **attrs)
        registry.counter(
            "index_lifecycle_total", "index lifecycle transitions",
            labelnames=("event",)).inc(event=name)


def load_index(snapshot_dir: str, *, expect_L=None, registry=None,
               device=None):
    """Reconstruct a saved index on ``device`` (the card by default); no
    gallery projection, no k-means.

    ``expect_L``: a metric factor the snapshot must have been built under
    — a shape or fingerprint mismatch raises ValueError before any array
    loads (load without it and ``swap_metric`` to recover). ``registry``
    receives the ``index_snapshot_load`` event.

    Returns the restored index (same type, same ``version``). Raises
    FileNotFoundError on a missing or incomplete snapshot and ValueError
    on a format or fingerprint mismatch.
    """
    dev = resolve_device(device)
    path = os.path.join(snapshot_dir, MANIFEST)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no snapshot manifest at {path} (incomplete or missing "
            f"snapshot)")
    with open(path) as f:
        manifest = json.load(f)
    if manifest["format"] != FORMAT:
        raise ValueError(f"snapshot format {manifest['format']} != "
                         f"supported {FORMAT}")
    if expect_L is not None:
        # shape first: a rank-mismatched factor can never fingerprint-
        # match, and the structural diagnosis is the useful one
        saved_shape = manifest.get("l_shape")
        expect_shape = list(host_array(expect_L, np.float32).shape)
        if saved_shape is not None and saved_shape != expect_shape:
            raise ValueError(
                f"snapshot metric factor has shape "
                f"{tuple(saved_shape)} but expect_L is "
                f"{tuple(expect_shape)}: rank-mismatched L (the gallery "
                f"was projected at a different (d_out, d_in); load "
                f"without expect_L and swap_metric, or rebuild)")
        got, want = manifest["l_fingerprint"], l_fingerprint(expect_L)
        if got != want:
            raise ValueError(
                f"snapshot metric fingerprint {got} != expected {want}: "
                f"the gallery was projected under a different L (load "
                f"without expect_L and swap_metric, or rebuild)")

    base = _load_base(os.path.join(snapshot_dir, "base.npz"),
                      manifest["base"], dev)
    if manifest["type"] != "MutableIndex":
        base.version = manifest["version"]
        _emit(base, registry, "snapshot_load", type=manifest["type"],
              size=manifest["size"], version=manifest["version"],
              dir=snapshot_dir)
        return base

    with np.load(os.path.join(snapshot_dir, "mutable.npz")) as z:
        mz = {k: z[k] for k in z.files}
    raw_base = raw_delta = None
    if "raw" in manifest["segments"]:
        with np.load(os.path.join(snapshot_dir, "raw.npz")) as z:
            raw_base, raw_delta = z["raw_base"], z["raw_delta"]
    meta = manifest["mutable"]
    mut = MutableIndex(base, base.L, ids=mz["base_ids"], raw=raw_base,
                       base_kwargs=meta["base_kwargs"],
                       auto_compact_delta=meta["auto_compact_delta"],
                       auto_compact_dead=meta["auto_compact_dead"])
    mut._restore(dead_base=mz["dead_base"], delta_gp=mz["delta_gp"],
                 delta_gn=mz["delta_gn"], delta_ids=mz["delta_ids"],
                 dead_delta=mz["dead_delta"], raw_delta=raw_delta,
                 next_id=meta["next_id"], version=manifest["version"],
                 counters=meta)
    _emit(mut, registry, "snapshot_load", type=manifest["type"],
          size=manifest["size"], version=manifest["version"],
          dir=snapshot_dir)
    return mut
