"""Residual product quantization: uint8 codes + ADC scoring for IVF retrieval.

Counterpart of ``repro/serve/pq.py`` on one device:

  * ``ProductQuantizer`` — splits the k-dim *residual* space (row minus
    its IVF centroid) into ``n_subspaces`` contiguous subspaces and
    k-means-quantizes each (``2**bits`` codewords, uint8 codes).
  * ``IVFPQIndex`` — the IVF layout (cluster-major capacity-padded
    segments) holding codes instead of rows, scored by asymmetric
    distance computation (ADC):

        ||qp - (c + r̂)||² = ||qp - c||² - 2⟨qp, r̂⟩ + (||r̂||² + 2⟨c, r̂⟩)

    — the centroid distance from the probe step, one (n_subspaces,
    2**bits) inner-product table per query, and a per-row f32 ``t`` baked
    at encode time. The scan is the ``pq_adc`` kernel on the card (its
    plain version on the CPU), bit-identical either way.
  * optional **exact re-rank** of the top ``rerank_depth`` ADC candidates
    against the full-precision rows: ``store="device"`` keeps them on the
    index's device (the projected gallery the caller passed, not a copy)
    and re-ranks in the same call; ``store="host"`` keeps them in host
    memory and gathers the candidates' rows there per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import BIG, full_f32, topk_by_distance
from repro_torch.kernels.metric_topk import project_gallery
from repro_torch.kernels.pq_adc import pq_adc_topk
from repro_torch.serve import scan
from repro_torch.serve.ivf import (_ROW_BLOCK, StepClock, cluster_segments,
                                   kmeans_projected, probe)


@dataclasses.dataclass(eq=False)
class ProductQuantizer:
    """Per-subspace k-means codebooks over a k-dim vector space.

    ``codebooks`` (n_subspaces, 2**bits, sub_dim) f32; ``dim`` the
    un-padded input dimensionality (zero-padded up to n_subspaces *
    sub_dim inside; zero pad columns are distance-neutral).
    """

    codebooks: torch.Tensor
    dim: int

    @property
    def n_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def n_codes(self) -> int:
        return self.codebooks.shape[1]

    @property
    def sub_dim(self) -> int:
        return self.codebooks.shape[2]

    @property
    def bits(self) -> int:
        return int(self.n_codes - 1).bit_length() if self.n_codes > 1 else 1

    @property
    def code_bytes(self) -> int:
        """Stored bytes per encoded vector (one uint8 per subspace)."""
        return self.n_subspaces

    @classmethod
    def train(cls, vecs, n_subspaces: int = 8, bits: int = 8, *,
              iters: int = 10, seed: int = 0,
              device=None) -> "ProductQuantizer":
        """Fit per-subspace codebooks on (N, dim) training vectors (on
        ``device``, the card by default): subspace s runs
        ``kmeans_projected`` with seed ``seed + s``. With N < 2**bits the
        codebook pads by repeating real codewords."""
        if not 1 <= bits <= 8:
            raise ValueError(f"bits must be in 1..8 (uint8 codes), "
                             f"got {bits}")
        vecs = torch.as_tensor(vecs, dtype=torch.float32).to(
            resolve_device(device))
        if vecs.dim() != 2:
            raise ValueError(f"vecs must be (N, dim), got "
                             f"{tuple(vecs.shape)}")
        N, dim = vecs.shape
        if N < 1:
            raise ValueError("cannot train on an empty set")
        if n_subspaces < 1 or n_subspaces > dim:
            raise ValueError(f"n_subspaces={n_subspaces} outside 1..{dim}")
        sub = -(-dim // n_subspaces)                       # ceil
        vecs = _pad_cols(vecs, sub * n_subspaces)
        n_codes = 1 << bits
        books = []
        for s in range(n_subspaces):
            c = min(n_codes, N)
            cent, _, _ = kmeans_projected(
                vecs[:, s * sub:(s + 1) * sub].contiguous(), c, iters=iters,
                seed=seed + s)
            if c < n_codes:                   # pad by repeating real rows
                cent = cent[torch.arange(n_codes, device=cent.device) % c]
            books.append(cent)
        return cls(codebooks=torch.stack(books), dim=dim)

    def _split(self, vecs):
        """(N, dim) -> (N, n_subspaces, sub_dim), zero-padding dim."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32).to(
            self.codebooks.device)
        if vecs.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got "
                             f"{vecs.shape[1]}")
        vecs = _pad_cols(vecs, self.n_subspaces * self.sub_dim)
        return vecs.reshape(vecs.shape[0], self.n_subspaces, self.sub_dim)

    def encode(self, vecs, block_rows: int = 16384) -> torch.Tensor:
        """Quantize (N, dim) vectors to (N, n_subspaces) uint8 codes: the
        nearest codeword per subspace, ties to the smaller code."""
        full_f32()
        parts = self._split(vecs)
        cn = torch.sum(torch.square(self.codebooks), dim=2)   # (S, K)
        out = []
        for s in range(0, parts.shape[0], block_rows):
            cross = torch.einsum("nsd,skd->nsk", parts[s:s + block_rows],
                                 self.codebooks)
            out.append(torch.argmin(cn[None] - 2.0 * cross, dim=2)
                       .to(torch.uint8))
        if not out:
            return torch.zeros((0, self.n_subspaces), dtype=torch.uint8,
                               device=self.codebooks.device)
        return torch.cat(out)

    def decode(self, codes) -> torch.Tensor:
        """Reconstruct (N, dim) f32 vectors from (N, n_subspaces) codes."""
        codes = torch.as_tensor(codes).to(self.codebooks.device).long()
        s = torch.arange(self.n_subspaces, device=codes.device)
        out = self.codebooks[s[None, :], codes]            # (N, S, sub)
        return out.reshape(codes.shape[0], -1)[:, :self.dim]

    def ip_tables(self, q) -> torch.Tensor:
        """Per-query inner-product tables (Nq, n_subspaces, 2**bits):
        entry [i, s, b] = <q_i restricted to subspace s, codebook[s, b]>."""
        full_f32()
        return torch.einsum("nsd,skd->nsk", self._split(q), self.codebooks)

    def sqdist_tables(self, q) -> torch.Tensor:
        """Per-query squared-distance tables (Nq, n_subspaces, 2**bits):
        entry [i, s, b] = ||q_i|_s - codebook[s, b]||²."""
        full_f32()
        split = self._split(q)
        qn = torch.sum(torch.square(split), dim=2)
        cn = torch.sum(torch.square(self.codebooks), dim=2)
        cross = torch.einsum("nsd,skd->nsk", split, self.codebooks)
        return qn[:, :, None] + cn[None] - 2.0 * cross

    def adc(self, tables, codes) -> torch.Tensor:
        """(Nq, N): the sum over subspaces of each query's table entries
        at each row's codes (tables from ``ip_tables`` / ``sqdist_tables``,
        codes (N, n_subspaces) uint8)."""
        S, K = self.n_subspaces, self.n_codes
        codes = torch.as_tensor(codes).to(tables.device)
        flat = torch.arange(S, device=tables.device) * K + codes.long()
        t = tables.reshape(tables.shape[0], S * K)
        picked = t[:, flat.reshape(-1)]                    # (Nq, N*S)
        return picked.reshape(tables.shape[0], -1, S).sum(dim=2)


def _pad_cols(x, width: int):
    if x.shape[1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


# -- the index ---------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class IVFPQIndex:
    """IVF segments over uint8 PQ codes + ADC scan + optional exact rerank.

    Same cluster-major capacity-padded layout as IVFIndex, with
    ``code_bytes`` per row instead of 4k. ``gp_full``/``gn_full`` are the
    full-precision projected rows for the rerank: on the index's device
    when ``store == "device"``, in host memory when ``store == "host"``.
    """

    L: torch.Tensor                 # (k, d) metric factor
    centroids: torch.Tensor         # (C, k) cluster centers
    pq: ProductQuantizer            # residual codebooks
    codes_pad: torch.Tensor         # (C*cap, S) uint8; 0 on pad slots
    t_pad: torch.Tensor             # (C*cap,) ||r̂||²+2⟨c,r̂⟩; BIG on pads
    ids_pad: torch.Tensor           # (C*cap,) int32 row ids; -1 on pads
    gp_full: torch.Tensor           # (M, k) exact rows (see store)
    gn_full: torch.Tensor           # (M,) their norms
    cap: int                        # per-cluster segment capacity
    n_clusters: int
    nprobe: int                     # default clusters scanned per query
    n_rows: int                     # real (unpadded) gallery size M
    rerank_depth: int = 50          # default exact-rerank pool (0 = off)
    store: str = "device"           # rerank row store: "device" | "host"
    scan_impl: str = "auto"         # see scan.resolve_scan_impl
    block_q: int = 64               # query chunk of the plain (CPU) scan
    version: int = 0

    @classmethod
    def build(cls, L, gallery, n_clusters: int = 64, nprobe: int = 8, *,
              n_subspaces: int = 8, bits: int = 8, rerank_depth: int = 50,
              store: str = "device", scan_impl: str = "auto",
              iters: int = 10, seed: int = 0, cap_factor: float = 1.25,
              mesh=None, device=None) -> "IVFPQIndex":
        """Project the gallery (on ``device``, the card by default),
        cluster, train PQ on residuals, encode (see build_projected)."""
        dev = resolve_device(device)
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        gp, gn = project_gallery(L, torch.as_tensor(gallery).to(dev))
        return cls.build_projected(
            L, gp, gn, n_clusters=n_clusters, nprobe=nprobe,
            n_subspaces=n_subspaces, bits=bits, rerank_depth=rerank_depth,
            store=store, scan_impl=scan_impl, iters=iters, seed=seed,
            cap_factor=cap_factor, mesh=mesh, device=dev)

    @classmethod
    def build_projected(cls, L, gp, gn, n_clusters: int = 64,
                        nprobe: int = 8, *, n_subspaces: int = 8,
                        bits: int = 8, rerank_depth: int = 50,
                        store: str = "device", scan_impl: str = "auto",
                        iters: int = 10, seed: int = 0,
                        cap_factor: float = 1.25,
                        pq_train_rows: int = 20_000, mesh=None,
                        device=None, timings: Optional[dict] = None
                        ) -> "IVFPQIndex":
        """Cluster + encode already-projected rows (gp (M,k), gn (M,)).

        Same layout as IVFIndex.build_projected; the residual PQ trains
        on a seeded subsample of ``pq_train_rows`` residuals (the
        reference's ``np.random.RandomState(seed)`` draw). With
        ``store="device"`` the rerank rows are ``gp`` itself, not a copy.
        ``timings``, when given, receives the seconds of each build step
        ("kmeans", "balance_layout", "pq_train", "encode"), each ended by
        a device synchronisation.
        """
        if store not in ("device", "host"):
            raise ValueError(f"unknown store {store!r} (device|host)")
        if mesh is not None:
            raise NotImplementedError(
                "IVFPQIndex is single-device (the sharded path is not "
                "ported)")
        dev = resolve_device(device)
        scan.resolve_scan_impl(scan_impl, device=dev)
        L = torch.as_tensor(L, dtype=torch.float32).to(dev)
        gp = torch.as_tensor(gp, dtype=torch.float32).to(dev)
        gn = torch.as_tensor(gn, dtype=torch.float32).to(dev)
        clock = StepClock(dev, timings)
        centroids, assign, cap, order, slots = cluster_segments(
            L, gp, n_clusters, iters=iters, seed=seed, cap_factor=cap_factor,
            clock=clock)
        clock.lap("balance_layout")
        M, C = gp.shape[0], n_clusters

        sel = torch.arange(M, device=dev)
        if 0 < pq_train_rows < M:
            sel = torch.from_numpy(np.random.RandomState(seed).choice(
                M, pq_train_rows, replace=False)).to(dev)
        pq = ProductQuantizer.train(gp[sel] - centroids[assign[sel]],
                                    n_subspaces=n_subspaces, bits=bits,
                                    iters=iters, seed=seed, device=dev)
        clock.lap("pq_train")
        codes = torch.empty((M, pq.n_subspaces), dtype=torch.uint8,
                            device=dev)
        t = torch.empty((M,), dtype=torch.float32, device=dev)
        for s in range(0, M, _ROW_BLOCK):
            cents = centroids[assign[s:s + _ROW_BLOCK]]
            codes[s:s + _ROW_BLOCK] = pq.encode(gp[s:s + _ROW_BLOCK] - cents)
            t[s:s + _ROW_BLOCK] = _t_term(pq, codes[s:s + _ROW_BLOCK], cents)

        codes_pad = torch.zeros((C * cap, pq.n_subspaces), dtype=torch.uint8,
                                device=dev)
        t_pad = torch.full((C * cap,), BIG, dtype=torch.float32, device=dev)
        ids_pad = torch.full((C * cap,), -1, dtype=torch.int32, device=dev)
        codes_pad[slots] = codes[order]
        t_pad[slots] = t[order]
        ids_pad[slots] = order.to(torch.int32)
        clock.lap("encode")
        if store == "host":
            gp, gn = gp.cpu(), gn.cpu()
        return cls(L=L.contiguous(), centroids=centroids, pq=pq,
                   codes_pad=codes_pad, t_pad=t_pad, ids_pad=ids_pad,
                   gp_full=gp, gn_full=gn, cap=cap, n_clusters=C,
                   nprobe=min(nprobe, C), n_rows=M,
                   rerank_depth=rerank_depth, store=store,
                   scan_impl=scan_impl)

    # -- MetricIndex surface -------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.codes_pad.device

    @property
    def size(self) -> int:
        """Real (unpadded) gallery rows."""
        return self.n_rows

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def code_bytes_per_row(self) -> int:
        """Device bytes scanned per row: uint8 codes + the f32 ``t``."""
        return self.pq.code_bytes + 4

    @property
    def compression_ratio(self) -> float:
        """Full-precision segment bytes / PQ segment bytes per row."""
        return (4 * self.gp_full.shape[1] + 4) / self.code_bytes_per_row

    def topk(self, queries, k_top: int, nprobe: Optional[int] = None,
             rerank: Optional[int] = None, scan_impl: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dists (Nq, k_top) ascending, row ids (Nq, k_top) int32).

        ``nprobe``: clusters scanned (defaults to the build setting).
        ``rerank``: exact-rerank pool (defaults to ``rerank_depth``; 0
        returns raw ADC distances, > 0 re-scores that many ADC candidates
        against the full-precision rows and returns exact distances).
        ``scan_impl``: checked against the index's device.
        """
        if k_top > self.size:
            raise ValueError(f"k_top={k_top} > gallery size {self.size}")
        np_ = self.nprobe if nprobe is None else nprobe
        if np_ < 1:
            raise ValueError(f"nprobe must be >= 1, got {np_}")
        np_ = min(np_, self.n_clusters)
        rr = self.rerank_depth if rerank is None else rerank
        rr = min(rr, np_ * self.cap)
        if rr:
            rr = max(rr, k_top)
        if max(k_top, rr) > np_ * self.cap:
            raise ValueError(
                f"k_top={k_top} > nprobe*cap={np_ * self.cap} scanned "
                f"rows per query; raise nprobe")
        scan.resolve_scan_impl(self.scan_impl, scan_impl, self.device)
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        qp = scan.project_queries(self.L, q)
        probes, dc = probe(qp, self.centroids, np_)
        C, cap = self.n_clusters, self.cap
        S, K = self.pq.n_subspaces, self.pq.n_codes
        tables = self.pq.ip_tables(qp).reshape(qp.shape[0], S * K)
        d, i = pq_adc_topk(tables, dc, probes, self.codes_pad.view(C, cap, S),
                           self.t_pad.view(C, cap), self.ids_pad.view(C, cap),
                           kk=max(k_top, rr), block_q=self.block_q)
        if rr == 0:
            return d, i
        if self.store == "host":
            return self._rerank_host(qp, i, k_top)
        # device store: gather only the candidates' full-precision rows
        safe = torch.clamp_min(i, 0).long()
        norms = torch.where(i >= 0, self.gn_full[safe],
                            torch.full_like(d, BIG))
        return _exact_rerank(qp, self.gp_full[safe], norms, i, k_top)

    def _rerank_host(self, qp, cand_ids, k_top: int):
        """Re-score ADC candidates against the host full-precision rows:
        the gather runs in host memory, the exact distances on the
        index's device. -1 candidates keep their id and a BIG distance."""
        ci = cand_ids.cpu()
        safe = torch.clamp_min(ci, 0).long()
        rows = self.gp_full[safe].to(self.device)
        norms = torch.where(ci >= 0, self.gn_full[safe],
                            torch.full(ci.shape, BIG)).to(self.device)
        return _exact_rerank(qp, rows, norms, cand_ids, k_top)

    def probe_stats(self, queries, nprobe: Optional[int] = None):
        """Diagnostic: (probes (Nq, nprobe), centroid dists) as numpy —
        which segments a query would scan."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        np_ = min(self.nprobe if nprobe is None else nprobe, self.n_clusters)
        probes, dc = probe(scan.project_queries(self.L, q), self.centroids,
                           np_)
        return probes.cpu().numpy(), dc.cpu().numpy()


def _exact_rerank(qp, rows, norms, ids, k_top: int):
    """Exact (projected-space) rescore of gathered candidate rows: qp
    (Nq, k), rows (Nq, R, k), norms (Nq, R) with BIG on -1 sentinels, ids
    (Nq, R). Returns the (distance, id)-merged exact top k_top."""
    full_f32()
    cross = torch.einsum("qrk,qk->qr", rows, qp)
    qn = torch.sum(torch.square(qp), dim=1)
    d = torch.clamp_min(qn[:, None] + norms - 2.0 * cross, 0.0)
    d = torch.where(ids < 0, torch.full_like(d, BIG), d)
    return topk_by_distance(d, ids, k_top)


def _t_term(pq: ProductQuantizer, codes, cents):
    """Per-row additive ADC term ||r̂||² + 2⟨c, r̂⟩ (f32 (N,)); ``cents``
    (N, k) each row's own centroid."""
    dec = pq.decode(codes)
    return torch.sum(dec * dec, dim=1) + 2.0 * torch.sum(cents * dec, dim=1)
