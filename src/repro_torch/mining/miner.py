"""Hard-pair mining over the serving index: the retrieval stack as a
constraint *producer* for the trainer.

Counterpart of ``repro/mining/miner.py``. ``HardPairMiner`` runs batched
k-NN queries for a set of anchor rows through a ``RetrievalEngine`` over
any ``MetricIndex`` (on the card the index's kernel answers them:
``metric_topk``, ``ivf_scan`` or ``pq_adc``), then label-filters each
neighborhood under the *current* metric L:

  hard negative   the nearest different-class neighbors (LMNN's
                  impostors: the dissimilar pairs whose hinge is active);
  hard positive   a same-class row the current metric keeps *outside*
                  the anchor's k-NN neighborhood (a present kNN
                  violation, with a large pull-together gradient);
  semi-hard band  negatives farther than the farthest in-neighborhood
                  same-class row but within ``margin`` of it (FaceNet's
                  band), optionally clipped at the ``band_pct`` distance
                  percentile of the neighborhood.

The label filter runs on the host in numpy, on the (Nq, k) neighborhood
arrays the engine returns, with the caller's ``np.random.RandomState``
draws in the reference's order: the same neighborhoods give the same
pairs. The feature table may be a tensor on the engine's device; the
anchors' rows then reach ``engine.search`` as a device tensor (the
engine's hot-query LRU, when on, still keys them by their host bytes).

Mined output is index pairs (dict(a, b, sim), the contract of
``data/pairs.sample_pair_indices``). ``mining/stream.MinedPairSource``
mixes them with uniform pairs under a curriculum;
``mining/loop.ClosedLoopTrainer`` refreshes the index's metric between
epochs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.data.pairs import distinct_draws
from repro_torch.device import host_array
from repro_torch.serve.engine import RetrievalEngine


@dataclasses.dataclass(frozen=True)
class MinerConfig:
    """Knobs of the neighborhood -> hard-pair label filter.

    k_neighbors: neighborhood size per query (the engine is asked for
      k_neighbors + 1 so the query's own row can be dropped).
    margin: the training hinge margin c — the semi-hard band is
      [d(hard positive), d(hard positive) + margin).
    semi_hard: restrict negatives to the band. When a query has no
      in-band negative (every different-class row pushed out of margin)
      and ``fallback_nearest`` is set, the plain nearest negative is
      used instead so late-training yield never hits zero.
    band_pct: clip the band at this distance percentile of the
      neighborhood (100 = no clip) — guards against a degenerate L
      whose "band" spans the whole gallery.
    max_negatives / max_positives: pairs kept per query.
    pos_candidates: same-class rows sampled per anchor and tested for
      neighborhood membership; the ones *outside* the neighborhood
      (present kNN violations) become hard positives, up to
      max_positives.
    """

    k_neighbors: int = 20
    margin: float = 1.0
    semi_hard: bool = True
    fallback_nearest: bool = True
    band_pct: float = 100.0
    max_negatives: int = 2
    max_positives: int = 1
    pos_candidates: int = 8

    def __post_init__(self):
        if self.k_neighbors < 2:
            raise ValueError("k_neighbors must be >= 2 (need room for a "
                             "positive and a negative)")
        if not 0.0 < self.band_pct <= 100.0:
            raise ValueError(f"band_pct must be in (0, 100], got "
                             f"{self.band_pct}")
        if self.max_negatives < 0 or self.max_positives < 0:
            raise ValueError("max_negatives / max_positives must be >= 0")


@dataclasses.dataclass
class MiningResult:
    """Mined constraints + where they came from.

    ``pairs`` is dict(a, b, sim) of index arrays (a = anchor row, b =
    neighbor row, sim in {1, 0}) — the same shape
    ``data/pairs.sample_pair_indices`` returns, so every existing batch
    stream accepts it. ``stats`` records the yield per category and the
    engine's QPS during the mining queries.
    """

    pairs: dict
    stats: dict

    @property
    def n_pairs(self) -> int:
        return int(self.pairs["sim"].shape[0])


class HardPairMiner:
    """Batched k-NN mining against a MetricIndex through the engine path.

    The miner owns no index state: it holds the feature/label table the
    anchors are drawn from and a ``RetrievalEngine`` whose index the
    closed loop refreshes underneath it (``MutableIndex.swap_metric`` /
    an engine index swap both bump the version the engine's cache keys
    on, so mined neighborhoods always reflect the metric the index
    currently serves).
    """

    def __init__(self, engine, features, labels,
                 cfg: Optional[MinerConfig] = None, *,
                 query_batch: int = 512, warmup: bool = True,
                 frontend=None):
        """Args:
          engine: a RetrievalEngine, or any MetricIndex (wrapped in a
            fresh engine here — pass an engine to share its cache/stats
            with serving traffic).
          features / labels: (n, d) anchor rows + (n,) int labels. Index
            row ids must index this table (build the index over the same
            rows, external ids 0..n-1). ``features`` may be a tensor (kept
            where it lies, not copied); labels go to the host.
          cfg: filter knobs (MinerConfig defaults).
          query_batch: anchors per engine.search call.
          warmup: run the engine's (bucket, k_neighbors + 1) searches up
            front (``engine.warmup``), so the first sweep pays neither
            the kernel's build nor its first launches.
          frontend: optional RequestScheduler over the same engine —
            mining queries then ride its ``mining`` priority class
            instead of calling the engine directly, so serving traffic
            shapes (and can shed) the mining load. Anchors the front end
            rejects or expires mine nothing this sweep (counted in
            stats["n_dropped"]; the loop retries them next epoch).
        """
        self.cfg = cfg or MinerConfig()
        if not isinstance(engine, RetrievalEngine):
            engine = RetrievalEngine(engine, k_top=self.cfg.k_neighbors + 1)
        self.engine = engine
        self.frontend = frontend
        if frontend is not None and self.cfg.k_neighbors + 1 > engine.k_top:
            raise ValueError(
                f"k_neighbors + 1 = {self.cfg.k_neighbors + 1} exceeds "
                f"the front end's engine k_top={engine.k_top}; the "
                f"scheduler rejects oversized k (size the engine or "
                f"shrink the neighborhood)")
        self.features = (features.detach().to(torch.float32)
                         if torch.is_tensor(features)
                         else np.asarray(features, np.float32))
        self.labels = host_array(labels)
        if self.labels.shape[0] != self.features.shape[0]:
            raise ValueError(
                f"labels ({self.labels.shape[0]}) != features "
                f"({self.features.shape[0]}) rows")
        self.query_batch = int(query_batch)
        self.n_mines = 0
        # obs: mining volume lands on the shared engine registry, labeled
        # by pair kind, so one snapshot covers serving AND the closed loop
        self.registry = getattr(self.engine, "registry", None)
        if self.registry is not None:
            self._c_mines = self.registry.counter(
                "miner_mines_total", "mine() sweeps")
            self._c_queries = self.registry.counter(
                "miner_queries_total", "anchor queries mined")
            self._c_pairs = self.registry.counter(
                "miner_pairs_total", "mined training pairs by kind",
                labelnames=("kind",))
            self._c_starved = self.registry.counter(
                "miner_starved_total",
                "anchors that yielded no pair at all")
            self._c_dropped = self.registry.counter(
                "miner_dropped_total",
                "anchors shed by the traffic front end (rejected or "
                "deadline-expired under the mining class)")
        # class -> row ids, for hard-positive candidate sampling
        order = np.argsort(self.labels, kind="stable")
        classes, starts = np.unique(self.labels[order], return_index=True)
        bounds = np.append(starts, len(order))
        self._class_rows = {int(c): order[bounds[i]:bounds[i + 1]]
                            for i, c in enumerate(classes)}
        if warmup:
            # same clamp mine() applies: a gallery smaller than the
            # neighborhood still mines (and must still warm up)
            self.engine.warmup(ks=[min(self.cfg.k_neighbors + 1,
                                       self.engine.index.size)])

    # -- mining --------------------------------------------------------------

    def _neighborhoods(self, qid, k):
        """(dists (n,k), ids (n,k), served (n,) bool) for one anchor
        chunk. Direct engine path by default; with a front end attached,
        per-anchor futures through its ``mining`` priority class —
        anchors the scheduler sheds (queue full, deadline expired, or a
        failed batch) come back unserved and are skipped this sweep."""
        feats = self.features
        if torch.is_tensor(feats):
            feats = feats[torch.from_numpy(qid).to(feats.device)]
        else:
            feats = feats[qid]
        if self.frontend is None:
            d, i = self.engine.search(feats, k_top=k)
            return (np.asarray(d), np.asarray(i),
                    np.ones(len(qid), bool))
        feats = host_array(feats)        # the scheduler takes host rows
        futs = []
        for row in feats:
            try:
                futs.append(self.frontend.submit(row, k_top=k,
                                                 priority="mining"))
            except Exception:       # RejectedError: admission shed it
                futs.append(None)
        dists = np.full((len(qid), k), np.inf, np.float32)
        ids = np.full((len(qid), k), -1, np.int64)
        served = np.zeros(len(qid), bool)
        for row, fut in enumerate(futs):
            if fut is None:
                continue
            try:
                dists[row], ids[row] = fut.result()
                served[row] = True
            except Exception:       # expired / cancelled / batch failed
                pass
        return dists, ids, served

    def mine(self, query_ids=None, n_queries: Optional[int] = None,
             seed: int = 0) -> MiningResult:
        """Mine hard pairs for a set of anchor rows.

        Either pass explicit ``query_ids`` (row indices into the feature
        table) or ``n_queries`` anchors drawn uniformly (seeded).
        Returns a MiningResult; ``pairs`` may be empty if every
        neighborhood is single-class (stats say which filter starved).
        """
        rng = np.random.RandomState(seed)
        if query_ids is None:
            if n_queries is None:
                raise ValueError("pass query_ids or n_queries")
            if n_queries < 1:
                raise ValueError(f"n_queries must be >= 1, got "
                                 f"{n_queries}")
            # distinct draws without permuting the whole table
            # (rng.choice(replace=False) is O(table) per mine call)
            query_ids = distinct_draws(
                rng, len(self.labels),
                min(n_queries, len(self.labels)))
        query_ids = np.asarray(query_ids, np.int64)
        if len(query_ids) == 0:
            raise ValueError("query_ids is empty")
        k = min(self.cfg.k_neighbors + 1, self.engine.index.size)

        a_out, b_out, sim_out = [], [], []
        n_hard_neg = n_semi = n_fallback = n_hard_pos = n_starved = 0
        n_dropped = 0
        t_busy0 = self.engine.busy_s
        n_dev0 = self.engine.n_device_queries
        for s in range(0, len(query_ids), self.query_batch):
            qid = query_ids[s:s + self.query_batch]
            dists, ids, served = self._neighborhoods(qid, k)
            n_dropped += int((~served).sum())
            if not served.all():    # shed anchors mine nothing (a row
                qid = qid[served]   # of -1s would fake hard positives)
                dists, ids = dists[served], ids[served]
            if len(qid) == 0:
                continue
            a, b, sim, st = self._filter(qid, np.asarray(dists),
                                         np.asarray(ids), rng)
            a_out.append(a)
            b_out.append(b)
            sim_out.append(sim)
            n_hard_neg += st["hard_neg"]
            n_semi += st["semi"]
            n_fallback += st["fallback"]
            n_hard_pos += st["hard_pos"]
            n_starved += st["starved"]
        self.n_mines += 1

        pairs = {
            "a": (np.concatenate(a_out) if a_out
                  else np.zeros(0, np.int64)),
            "b": (np.concatenate(b_out) if b_out
                  else np.zeros(0, np.int64)),
            "sim": (np.concatenate(sim_out).astype(np.int32) if sim_out
                    else np.zeros(0, np.int32))}
        nq = max(len(query_ids), 1)
        est = self.engine.stats()
        # QPS over *this mine's* device queries, not the engine's
        # lifetime average (the engine may have served unrelated
        # retrieval traffic before)
        busy = est["busy_s"] - t_busy0
        dev = est["n_device_queries"] - n_dev0
        stats = {
            "n_queries": int(len(query_ids)),
            "n_pairs": int(pairs["sim"].shape[0]),
            "n_hard_neg": int(n_hard_neg),
            "n_semi_hard": int(n_semi),
            "n_fallback_neg": int(n_fallback),
            "n_hard_pos": int(n_hard_pos),
            "n_starved": int(n_starved),
            "n_dropped": int(n_dropped),
            "neg_yield": n_hard_neg / nq,
            "pos_yield": n_hard_pos / nq,
            "mine_busy_s": busy,
            "engine_qps": dev / busy if busy > 0 else 0.0,
            "index_version": self.engine.index.version,
        }
        if self.registry is not None:
            self._c_mines.inc()
            self._c_queries.inc(stats["n_queries"])
            self._c_starved.inc(stats["n_starved"])
            self._c_dropped.inc(stats["n_dropped"])
            for kind, key in (("hard_neg", "n_hard_neg"),
                              ("semi_hard", "n_semi_hard"),
                              ("fallback_neg", "n_fallback_neg"),
                              ("hard_pos", "n_hard_pos")):
                self._c_pairs.inc(stats[key], kind=kind)
        return MiningResult(pairs=pairs, stats=stats)

    # -- label filter --------------------------------------------------------

    def _filter(self, qid, dists, ids, rng):
        """Neighborhoods (Nq, k) -> hard pairs. Vectorized on the host:
        selection is argsort/broadcast tricks over boolean masks, never a
        Python loop over queries."""
        cfg = self.cfg
        # drop the anchor's own row, unservable slots (-1 from
        # under-filled IVF probes), and ids beyond the label table (a
        # mutable index can serve rows upserted after the table was
        # made); columns arrive distance-ascending
        valid = ((ids >= 0) & (ids < len(self.labels))
                 & (ids != qid[:, None]))
        same = np.zeros_like(valid)
        safe = np.where(valid, ids, 0)
        same[valid] = (self.labels[safe] == self.labels[qid][:, None])[valid]
        diff = valid & ~same
        dists = np.where(valid, dists, np.inf)

        # the farthest in-neighborhood same-class row bounds the
        # territory the anchor currently "wins"; it anchors the
        # semi-hard band below
        kcols = ids.shape[1]
        rev_pos = np.argsort(~same[:, ::-1], axis=1, kind="stable")
        far_col = (kcols - 1) - rev_pos[:, 0]
        has_same = same.any(axis=1)
        d_hard_pos = np.where(
            has_same,
            np.take_along_axis(dists, far_col[:, None], axis=1)[:, 0], 0.0)

        # negative band: nearest different-class columns, optionally
        # clipped to the semi-hard band [d_hard_pos, d_hard_pos + margin)
        # and the band_pct distance percentile of the neighborhood
        cand = diff
        if cfg.semi_hard:
            # the band is only defined for anchors with a same-class
            # neighbor to anchor it on; others go to the fallback (a
            # d_hard_pos of 0 would degenerate the band into a plain
            # dist < margin cutoff and misreport those rows as
            # semi-hard)
            band = cand & has_same[:, None] \
                & (dists >= d_hard_pos[:, None]) \
                & (dists < (d_hard_pos + cfg.margin)[:, None])
            if cfg.band_pct < 100.0:
                lim = np.nanpercentile(
                    np.where(valid, dists, np.nan), cfg.band_pct, axis=1)
                band &= dists <= lim[:, None]
            n_semi_rows = band.any(axis=1)
            if cfg.fallback_nearest:
                cand = np.where(n_semi_rows[:, None], band, diff)
            else:
                cand = band
        else:
            n_semi_rows = np.zeros(len(qid), bool)
        neg_cols = np.argsort(~cand, axis=1,
                              kind="stable")[:, :max(cfg.max_negatives, 1)]
        neg_ok = np.take_along_axis(cand, neg_cols, axis=1)

        a, b, sim = [], [], []
        n_neg = n_pos = 0
        if cfg.max_negatives > 0:
            an = np.broadcast_to(qid[:, None], neg_ok.shape)[neg_ok]
            bn = np.take_along_axis(safe, neg_cols, axis=1)[neg_ok]
            n_neg = len(an)
            a.append(an)
            b.append(bn)
            sim.append(np.zeros(len(an), np.int32))
        has_pos = np.zeros(len(qid), bool)
        if cfg.max_positives > 0:
            ap, bp = self._violating_positives(qid, ids, valid, rng)
            n_pos = len(ap)
            has_pos = np.isin(qid, ap)
            a.append(ap)
            b.append(bp)
            sim.append(np.ones(len(ap), np.int32))

        has_neg = neg_ok[:, 0] if cfg.max_negatives > 0 \
            else np.zeros(len(qid), bool)
        from_band = n_semi_rows & has_neg
        stats = {
            "hard_neg": n_neg,
            "semi": int(from_band.sum()),
            "fallback": int((has_neg & ~n_semi_rows).sum())
            if cfg.semi_hard else 0,
            "hard_pos": n_pos,
            "starved": int((~has_neg & ~has_pos).sum()),
        }
        return (np.concatenate(a) if a else np.zeros(0, np.int64),
                np.concatenate(b) if b else np.zeros(0, np.int64),
                np.concatenate(sim) if sim else np.zeros(0, np.int32),
                stats)

    def _violating_positives(self, qid, ids, valid, rng):
        """Hard positives: same-class rows the current metric keeps
        *outside* the anchor's neighborhood (the pairs a kNN eval is
        getting wrong right now — LMNN's "pull" step). Samples
        ``pos_candidates`` same-class rows per anchor and keeps up to
        ``max_positives`` that are not among the returned neighbors."""
        cfg = self.cfg
        nq, nc = len(qid), cfg.pos_candidates
        cand = np.empty((nq, nc), np.int64)
        qlab = self.labels[qid]
        for c in np.unique(qlab):               # grouped draw per class
            rows = self._class_rows[int(c)]
            m = qlab == c
            cand[m] = rows[rng.randint(0, len(rows), (int(m.sum()), nc))]
        # violating iff not the anchor itself and not a returned neighbor
        nbr = np.where(valid, ids, -1)
        ok = ~(cand[:, :, None] == nbr[:, None, :]).any(axis=2)
        ok &= cand != qid[:, None]
        order = np.argsort(~ok, axis=1, kind="stable")[:, :cfg.max_positives]
        sel_ok = np.take_along_axis(ok, order, axis=1)
        sel = np.take_along_axis(cand, order, axis=1)
        for j in range(1, sel.shape[1]):        # dedupe repeated draws
            sel_ok[:, j] &= (sel[:, j:j + 1] != sel[:, :j]).all(axis=1)
        return (np.broadcast_to(qid[:, None], sel.shape)[sel_ok],
                sel[sel_ok])
