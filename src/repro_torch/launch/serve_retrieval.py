"""Metric-retrieval serving launcher (exact / IVF / IVFPQ, micro-batched).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_retrieval \
          [--gallery-size 20000] [--train-steps 200] [--requests 500] \
          [--index exact|ivf|ivfpq] [--n-clusters 64] [--nprobe 8] \
          [--n-subspaces 8] [--bits 8] [--rerank-depth 50] \
          [--pq-store device|host] [--scan-impl auto] [--device cpu] \
          [--mutable] [--churn N] [--snapshot-dir DIR] [--warmup-ks 5,20] \
          [--scheduler [--deadline-ms MS] [--no-degrade] \
           [--high-watermark 32] [--low-watermark 4] \
           [--degrade-window-ms 50] [--restore-window-ms 500]] \
          [--tenants N [--shadow]] [--mine N] [--metrics-out FILE] \
          [--backend auto|xla|pallas] [--trace-sample R] [--trace-out FILE]

Counterpart of ``repro.launch.serve_retrieval`` for the single-device
index paths: builds a class-structured gallery (data.pairs), learns the
metric factor L with ``train_dml_single`` on held-out-split pairs (Eq. 4
through the ``dml_pair`` kernel on the card; ``--train-steps 0`` keeps a
random L), stands up the index (ExactIndex on metric_topk, IVFIndex on
ivf_scan or IVFPQIndex on pq_adc) -> RetrievalEngine -> MicroBatcher,
fires single-query traffic through the batcher and reports QPS, latency
percentiles, batch coalescing, the cache and neighbor class purity.
Runs on the card unless ``--device cpu`` is given.

``--mutable`` wraps the index in a MutableIndex (streaming upserts /
deletes / compaction / metric hot-swap; raw rows retained); ``--churn N``
then upserts N rows and deletes N after the traffic run and reports the
lifecycle counters. ``--snapshot-dir`` restarts without re-projecting: a
snapshot there is loaded (its L fingerprint checked against this run's
metric), else the built index is saved there (and again after churn).
``--warmup-ks`` runs extra k values up front.

``--scheduler`` swaps the MicroBatcher front door for the traffic-shaped
``RequestScheduler``: traffic is submitted under a 70/20/10 interactive /
batch / mining class mix with per-class deadlines (``--deadline-ms``
overrides), bounded admission queues, and (unless ``--no-degrade``) the
adaptive quality ladder derived from the index's own knobs —
``--high/--low-watermark`` and ``--degrade/--restore-window-ms`` tune the
load controller's hysteresis. The run prints the ladder, per-class
outcomes and latency, and each degradation transition with its trigger.

``--tenants N`` then stands up a ``TenantRouter`` serving N metrics over
one shared raw gallery on the same device (tenant 0 serves this run's
L, the rest seeded low-rank factors, all on ``--index``) and prints the
tenant block: per-tenant requests and the shared-gallery memory against
independent stacks. ``--shadow`` registers this run's L as a shadow arm
behind tenant 1, mirrors the tenant traffic through it, reports overlap
and latency deltas, and promotes it live.

``--mine N`` runs a ``HardPairMiner`` sweep for N anchors against the
live engine after the traffic run (under ``--scheduler`` through the
front end's ``mining`` class) and reports its yield and the engine's
QPS over the mining queries. ``--metrics-out FILE`` writes the run's
final MetricsRegistry snapshot, which ``launch/metrics_report.py``
renders.

``--backend`` is the reference's exact-scan knob: ``pallas`` is the
``metric_topk`` kernel and needs the card, ``xla`` the plain path on the
chosen device (the card included), ``auto`` (the default) the kernel on
the card and the plain path on the CPU. As in the reference, ``pallas``
is refused with ``--index ivf|ivfpq``, whose scans follow
``--scan-impl``. ``--trace-sample R`` samples request traces at rate R
(deterministic) and ``--trace-out FILE`` exports the sampled span trees
as JSONL.

``--data N`` shards the gallery over N ranks (the exact and IVF
indexes): the launcher spawns N processes through
``launch/mesh.spawn`` (on the card they share it over gloo; ``--device
cpu`` runs them on the CPU), or, under ``torchrun``, joins its group of
N. Every rank builds the same data and holds its share of the rows;
rank 0 trains L and broadcasts it, then runs the engine, the front door
and the report, and the other ranks follow its calls
(``serve/scan.py``). As in the reference, ``--data > 1`` refuses
``--tenants``, ``--mutable`` / ``--snapshot-dir``, ``--index ivfpq``
and ``--scan-impl pallas``. ``main`` returns rank 0's neighbours by
request.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch.core import dml
from repro_torch.core.ps.trainer import train_dml_single
from repro_torch.data import pairs as pairdata
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.mining import HardPairMiner, MinerConfig
from repro_torch.obs import percentile
from repro_torch.serve import (ExactIndex, IVFIndex, IVFPQIndex,
                               MicroBatcher, MutableIndex, RequestScheduler,
                               RetrievalEngine, SchedulerError, TenantRouter,
                               has_snapshot, load_index, save_index)
from repro_torch.serve import scan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", choices=["exact", "ivf", "ivfpq"],
                    default="exact")
    ap.add_argument("--n-clusters", type=int, default=64,
                    help="ivf/ivfpq: gallery segments")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="ivf/ivfpq: clusters scanned per query")
    ap.add_argument("--n-subspaces", type=int, default=8,
                    help="ivfpq: uint8 codes per row (code bytes/row)")
    ap.add_argument("--bits", type=int, default=8,
                    help="ivfpq: log2 codewords per subspace (1..8)")
    ap.add_argument("--rerank-depth", type=int, default=50,
                    help="ivfpq: ADC candidates re-scored exactly per "
                         "query (0 serves raw ADC distances)")
    ap.add_argument("--pq-store", choices=["device", "host"],
                    default="device",
                    help="ivfpq: where the full-precision rerank rows "
                         "live (host = host memory, saves device memory)")
    ap.add_argument("--scan-impl", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="ivf/ivfpq: the reference's segment-scan knob; "
                         "auto takes the kernel on the card and the plain "
                         "version on the CPU, pallas (kernel) needs the "
                         "card, xla (plain) needs --device cpu")
    ap.add_argument("--gallery-size", type=int, default=20000)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--proj-dim", type=int, default=32)
    ap.add_argument("--l-rank", type=int, default=None,
                    help="rows (d_out) of a low-rank rectangular L; "
                         "overrides --proj-dim")
    ap.add_argument("--n-classes", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--train-steps", type=int, default=200,
                    help="Eq. 4 training steps for L (0: a random L)")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--cache-size", type=int, default=1024,
                    help="engine hot-query LRU entries (0 disables)")
    ap.add_argument("--mutable", action="store_true",
                    help="wrap the index in a MutableIndex (retains raw "
                         "features for metric hot-swap)")
    ap.add_argument("--churn", type=int, default=0,
                    help="with --mutable: upsert+delete this many rows "
                         "after the traffic run")
    ap.add_argument("--snapshot-dir", default=None,
                    help="load the index from this snapshot if present, "
                         "else save the built index there")
    ap.add_argument("--warmup-ks", default=None,
                    help="comma-separated extra k values to run up front "
                         "(e.g. 5,20); --k is always included")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the traffic-shaped "
                         "RequestScheduler (priority classes, deadlines, "
                         "adaptive degradation) instead of the plain "
                         "MicroBatcher")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="scheduler: per-request deadline override in ms "
                         "(default: each class's own deadline)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="scheduler: disable the adaptive quality ladder "
                         "(admission control + deadlines only)")
    ap.add_argument("--high-watermark", type=int, default=32,
                    help="scheduler: queue depth that starts the "
                         "degrade window")
    ap.add_argument("--low-watermark", type=int, default=4,
                    help="scheduler: queue depth that starts the "
                         "restore window")
    ap.add_argument("--degrade-window-ms", type=float, default=50.0,
                    help="scheduler: sustained pressure before stepping "
                         "the ladder down")
    ap.add_argument("--restore-window-ms", type=float, default=500.0,
                    help="scheduler: sustained drain before stepping "
                         "back up")
    ap.add_argument("--tenants", type=int, default=0,
                    help="after the main run, stand up a TenantRouter "
                         "serving this many metrics over ONE shared raw "
                         "gallery (tenant 0 serves this run's L; the "
                         "rest get seeded low-rank factors) and report "
                         "per-tenant requests + the shared-gallery memory "
                         "ratio vs independent stacks")
    ap.add_argument("--shadow", action="store_true",
                    help="with --tenants: register this run's L as a "
                         "shadow arm behind tenant 1, mirror the tenant "
                         "traffic through it, report overlap/latency "
                         "deltas, and promote it live")
    ap.add_argument("--mine", type=int, default=0,
                    help="after the traffic run, mine hard pairs for "
                         "this many anchors against the live serving "
                         "engine (shares its cache and stats) and "
                         "report yield + mining QPS")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final MetricsRegistry snapshot (JSON) "
                         "here — launch/metrics_report.py renders it")
    ap.add_argument("--backend", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="exact scan: pallas = the metric_topk kernel "
                         "(needs the card), xla = the plain path on the "
                         "chosen device, auto = the kernel on the card "
                         "and the plain path on the CPU")
    ap.add_argument("--trace-out", default=None,
                    help="write sampled request traces here as JSONL "
                         "(one span tree per line)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="trace sampling rate in [0, 1] (deterministic: "
                         "rate 0.25 samples every 4th request)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernel's plain version)")
    ap.add_argument("--data", type=int, default=1,
                    help=">1 shards the gallery over that many ranks "
                         "(spawned, or torchrun's group)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if not 0.0 <= args.trace_sample <= 1.0:
        ap.error(f"--trace-sample must be in [0, 1], got "
                 f"{args.trace_sample}")
    if args.index in ("ivf", "ivfpq") and args.backend == "pallas":
        ap.error(f"--index {args.index} only supports --backend xla (the "
                 "fused pallas kernel serves the exact full-scan path)")
    if args.churn and not args.mutable:
        ap.error("--churn requires --mutable")
    if args.shadow and args.tenants < 2:
        ap.error("--shadow needs --tenants >= 2 (tenant 1 hosts the arm)")
    if args.tenants and args.data > 1:
        ap.error("--tenants is single-shard (incompatible with "
                 "--data > 1)")
    if args.data > 1 and (args.mutable or args.snapshot_dir):
        ap.error("--mutable / --snapshot-dir are single-shard "
                 "(incompatible with --data > 1)")
    if args.data > 1 and args.index == "ivfpq":
        ap.error("--index ivfpq is single-shard (incompatible with "
                 "--data > 1)")
    if args.data > 1 and args.scan_impl == "pallas":
        ap.error("--scan-impl pallas is single-shard (incompatible with "
                 "--data > 1)")
    device = resolve_device(args.device)
    if args.backend == "pallas" and device.type != "cuda":
        ap.error("--backend pallas is the metric_topk kernel, which needs "
                 "the card; --backend xla (or auto) runs the plain path "
                 "on the CPU")
    mesh = None
    if args.data > 1:
        if not torch.distributed.is_initialized():
            if "WORLD_SIZE" not in os.environ:
                return mesh_lib.spawn(main, args.data, device=device,
                                      args=(argv,), timeout=3600.0)[0]
            mesh_lib.join(device)
        mesh = mesh_lib.make_local_mesh(data=args.data)
        device = mesh.device

    # --- data + metric ---------------------------------------------------
    cfg = pairdata.PairDatasetConfig(
        n_samples=args.gallery_size, feat_dim=args.feat_dim,
        n_classes=args.n_classes, kind="noisy_subspace", noise=0.5, seed=0)
    feats, labels = pairdata.make_features(cfg)
    if args.l_rank is not None:         # low-rank knob wins over proj-dim
        args.proj_dim = args.l_rank
    dcfg = dml.DMLConfig(feat_dim=args.feat_dim, l_rank=args.proj_dim)
    if mesh is not None and mesh.rank != 0:     # rank 0's L, below
        L = torch.empty((args.proj_dim, args.feat_dim), device=device)
    elif args.train_steps > 0:
        train_pairs, _ = pairdata.train_eval_split(
            cfg, n_train_sim=4000, n_train_dis=4000,
            n_eval_sim=100, n_eval_dis=100)
        L, hist = train_dml_single(dcfg, train_pairs, steps=args.train_steps,
                                   batch_size=512, lr=2e-2, seed=0,
                                   device=device)
        print(f"trained L: objective {hist[0]['loss']:.3f} -> "
              f"{hist[-1]['loss']:.3f}")
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        L = dml.init_params(dcfg, gen, device)
    if mesh is not None:
        L = mesh.broadcast(L.contiguous())

    # --- serving stack ---------------------------------------------------
    ivf_kw = dict(n_clusters=args.n_clusters, nprobe=args.nprobe,
                  scan_impl=args.scan_impl)
    ivfpq_kw = dict(ivf_kw, n_subspaces=args.n_subspaces, bits=args.bits,
                    rerank_depth=args.rerank_depth, store=args.pq_store)
    base_kw = {"exact": {}, "ivf": ivf_kw, "ivfpq": ivfpq_kw}[args.index]
    t0 = time.perf_counter()
    gallery = torch.from_numpy(feats)
    loaded = bool(args.snapshot_dir) and has_snapshot(args.snapshot_dir)
    if loaded:
        index = load_index(args.snapshot_dir, expect_L=L, device=device)
        if args.mutable and not isinstance(index, MutableIndex):
            ap.error(f"--mutable requested but {args.snapshot_dir} holds "
                     f"a frozen {type(index).__name__} snapshot; point "
                     f"--snapshot-dir elsewhere or drop --mutable")
    elif args.mutable:
        index = MutableIndex.build(L, gallery, base=args.index,
                                   retain_raw=True, device=device, **base_kw)
    elif args.index == "ivfpq":
        index = IVFPQIndex.build(L, gallery, device=device, **ivfpq_kw)
    elif args.index == "ivf":
        index = IVFIndex.build(L, gallery, device=device, mesh=mesh,
                               **ivf_kw)
    else:
        index = ExactIndex.build(L, gallery, device=device, mesh=mesh)
    build_s = time.perf_counter() - t0
    exact = index.base if isinstance(index, MutableIndex) else index
    if isinstance(exact, ExactIndex):
        exact.backend = args.backend
    if args.snapshot_dir and not loaded:
        save_index(index, args.snapshot_dir)
        print(f"snapshot saved to {args.snapshot_dir}")
    if mesh is not None and mesh.rank != 0:
        scan.follow(index)
        return None
    with scan.lead(index) as served:
        return _front(args, index, served, exact, device, feats, labels, L,
                      base_kw, "loaded from snapshot" if loaded
                      else "built+projected", build_s)


def _front(args, index, served, exact, device, feats, labels, L, base_kw,
           verb, build_s):
    """The engine (over ``served``, what ``scan.lead(index)`` yields), the
    front door, the traffic and the report, on rank 0 (or the one
    process). Returns the neighbours by request."""
    engine = RetrievalEngine(served, k_top=args.k,
                             cache_size=args.cache_size)
    engine.tracer.sample_rate = args.trace_sample
    warm_ks = [args.k]
    if args.warmup_ks:
        warm_ks += [int(x) for x in args.warmup_ks.split(",")]
    warm_ks = sorted(set(warm_ks))
    engine.warmup(ks=warm_ks)
    shards = f", {index.n_shards} shards over {args.data} ranks" \
        if args.data > 1 else ""
    print(f"index[{type(index).__name__}]: {index.size} x {args.proj_dim} "
          f"on {device} ({engine.backend} path{shards}), {verb} in "
          f"{build_s:.2f}s")
    if isinstance(exact, ExactIndex):
        plain = exact.backend == "xla" or device.type != "cuda"
        print(f"  exact scan backend={exact.backend} "
              f"({'plain' if plain else 'kernel'} path)")
    ann = index.base if isinstance(index, MutableIndex) else index
    if isinstance(ann, (IVFIndex, IVFPQIndex)):
        scanned = ann.nprobe * ann.cap
        print(f"  {type(ann).__name__}: {ann.n_clusters} clusters, cap "
              f"{ann.cap}, nprobe {ann.nprobe} -> <= {scanned} of "
              f"{ann.size} rows scanned per query "
              f"({scanned / max(ann.size, 1):.1%}); "
              f"scan_impl={ann.scan_impl} (resolves to "
              f"{scan.resolve_scan_impl(ann.scan_impl, device=device)})")
    if isinstance(ann, IVFPQIndex):
        print(f"  pq: {ann.pq.n_subspaces} x {ann.pq.bits}-bit codes "
              f"({ann.code_bytes_per_row} B/row scanned vs "
              f"{4 * args.proj_dim + 4} full precision, "
              f"{ann.compression_ratio:.1f}x), rerank depth "
              f"{ann.rerank_depth}, store={ann.store}")
    if args.scheduler:
        front = RequestScheduler(
            engine, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, degrade=not args.no_degrade,
            high_watermark=args.high_watermark,
            low_watermark=args.low_watermark,
            degrade_window_s=args.degrade_window_ms / 1e3,
            restore_window_s=args.restore_window_ms / 1e3)
        front.warmup(ks=warm_ks)                # every ladder level
        if front.controller is not None:
            print(f"  scheduler ladder: "
                  f"{[dict(lv) for lv in front.controller.ladder]}")
    else:
        front = MicroBatcher(engine, max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms)

    # --- traffic ---------------------------------------------------------
    rng = np.random.RandomState(1)
    qids = rng.randint(0, len(feats), args.requests)
    noisy = feats[qids] + 0.1 * rng.randn(args.requests, args.feat_dim) \
        .astype(np.float32)
    if args.scheduler:
        mix = rng.choice(["interactive", "batch", "mining"],
                         size=args.requests, p=[0.7, 0.2, 0.1])
        deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
    t0 = time.perf_counter()
    pending, n_rejected = [], 0
    for i, qid in enumerate(qids):
        t_sub = time.perf_counter()
        try:
            if args.scheduler:
                fut = front.submit(noisy[i], priority=str(mix[i]),
                                   deadline_s=deadline)
            else:
                fut = front.submit(noisy[i])
            pending.append((qid, t_sub, fut))
        except SchedulerError:                  # typed backpressure
            n_rejected += 1
    lat, purity, n_expired, served = [], [], 0, {}
    for i, (qid, t_sub, fut) in enumerate(pending):
        try:
            _, nbr = fut.result(timeout=60)
        except SchedulerError:                  # deadline expired in queue
            n_expired += 1
            continue
        lat.append(time.perf_counter() - t_sub)
        served[i] = np.asarray(nbr)
        # a loaded post-churn snapshot can serve rows upserted after this
        # run's label table was made; score only known ids
        nbr = np.asarray(nbr)
        known = nbr[(nbr >= 0) & (nbr < len(labels))]
        if len(known):
            purity.append(float(np.mean(labels[known] == labels[qid])))
    wall = time.perf_counter() - t0

    # --- hard-pair mining against the live engine ------------------------
    # before front.close(): under --scheduler the miner rides the front
    # end's ``mining`` priority class, so the front door must still be
    # open. k_neighbors is sized so the mined k equals --k — the
    # scheduler rejects k above the engine's k_top.
    mine_stats = None
    if args.mine > 0:
        use_front = args.scheduler and args.k >= 3
        miner = HardPairMiner(
            engine, feats, labels,
            MinerConfig(k_neighbors=(args.k - 1 if use_front
                                     else max(args.k, 5))),
            frontend=front if use_front else None)
        mine_stats = miner.mine(n_queries=args.mine, seed=2).stats
        mine_stats["via_scheduler"] = use_front
    front.close()

    lat_ms = np.sort(np.asarray(lat)) * 1e3
    st = engine.stats()
    print(f"requests={args.requests} wall={wall:.2f}s "
          f"qps={args.requests / wall:.0f} "
          f"(device-side qps={st['qps']:.0f})")
    if lat_ms.size:
        p50, p99 = percentile(lat_ms, (50.0, 99.0))
        print(f"latency ms: p50={p50:.2f} p99={p99:.2f} "
              f"max={lat_ms[-1]:.2f}")
    print(f"batches={front.n_batches} "
          f"mean batch={np.mean(front.batch_sizes):.1f}")
    print(f"cache: {st['cache_hits']} hits / {st['cache_misses']} misses "
          f"({st['cache_entries']} entries)")
    print(f"neighbor class purity@{args.k}: {np.mean(purity):.3f} "
          f"(chance {1.0 / args.n_classes:.3f})")
    if args.scheduler:
        obs = st["frontend"]
        for name, c in obs["classes"].items():
            print(f"  class {name}: admitted {c['admitted']} "
                  f"completed {c['completed']} expired {c['expired']} "
                  f"rejected {c['rejected']} queue_depth "
                  f"{c['queue_depth']} p50={c['p50_ms']:.2f}ms "
                  f"p99={c['p99_ms']:.2f}ms")
        print(f"  degradation: level {obs['degradation_level']} "
              f"knobs {obs['degradation_knobs']} "
              f"({obs['n_transitions']} transition(s)); "
              f"{n_rejected} rejected at admission, "
              f"{n_expired} expired in queue")
        for tr in (front.controller.transitions if front.controller
                   else ()):
            print(f"    level {tr.level_from} -> {tr.level_to}: "
                  f"{tr.reason}")

    if mine_stats is not None:
        ms = mine_stats
        via = ("scheduler mining class" if ms["via_scheduler"]
               else "direct engine path")
        print(f"mining ({via}): {ms['n_pairs']} hard pairs from "
              f"{ms['n_queries']} anchors (neg yield "
              f"{ms['neg_yield']:.2f}/q, pos yield "
              f"{ms['pos_yield']:.2f}/q, {ms['n_semi_hard']} semi-hard, "
              f"{ms['n_fallback_neg']} fallback, {ms['n_dropped']} shed "
              f"by the front end) in "
              f"{ms['mine_busy_s']:.2f}s device time — engine now at "
              f"{ms['engine_qps']:.0f} qps over "
              f"{engine.stats()['n_device_queries']} device queries")

    # --- mutation lifecycle ----------------------------------------------
    if args.mutable and args.churn > 0:
        n = min(args.churn, index.size // 2)
        fresh = feats[rng.randint(0, len(feats), n)] \
            + 0.1 * rng.randn(n, args.feat_dim).astype(np.float32)
        new_ids = index.upsert(fresh)
        retire = index.live_ids()[:n]
        retire = retire[~np.isin(retire, new_ids)]
        index.delete(retire)
        _, i_m = engine.search(noisy[:8])
        st = engine.stats()
        print(f"churn: +{n} upserts / -{len(retire)} deletes -> "
              f"size {index.size}, delta_rows {st['delta_rows']}, "
              f"tombstones {st['tombstones']}, "
              f"compactions {st['compactions']} "
              f"(version {index.version}); new ids reachable: "
              f"{bool(np.isin(i_m, new_ids).any())}")
        if args.snapshot_dir:
            save_index(index, args.snapshot_dir)
            print(f"post-churn snapshot saved to {args.snapshot_dir}")

    # --- multi-tenant serving over the shared gallery --------------------
    if args.tenants > 0:
        # a fresh registry: the main engine's series are unscoped, tenant
        # engines label everything with tenant=...
        router = TenantRouter(feats, device=device, k_top=args.k)
        for i in range(args.tenants):
            if i == 0:
                ti_L = L
            else:       # seeded low-rank factors standing in for other
                        # surfaces' trained metrics
                t_rng = np.random.RandomState(100 + i)
                ti_L = t_rng.randn(max(args.proj_dim // 2, 2),
                                   args.feat_dim).astype(np.float32) * 0.1
            router.add_tenant(f"t{i}", ti_L, backend=args.index,
                              build_kwargs=base_kw)
        if args.shadow:
            router.register_shadow("t1", L, sample_rate=0.5)
        t_qids = rng.randint(0, len(feats), 64)
        for i, qid in enumerate(t_qids):
            router.search(f"t{i % args.tenants}",
                          noisy[qid % args.requests] if args.requests
                          else feats[qid])
        tob = router.observability()
        mem = tob["memory"]
        # the multi-tenant win: raw rows resident once, not per tenant
        per_tenant = mem["gallery"] + max(mem["tenants"].values())
        ratio = mem["total"] / max(per_tenant * args.tenants, 1)
        print(f"tenants: {args.tenants} metrics over one "
              f"{tob['gallery_rows']}-row gallery on {device}; resident "
              f"{mem['total'] / 1e6:.1f} MB vs ~"
              f"{per_tenant * args.tenants / 1e6:.1f} MB for "
              f"independent stacks ({ratio:.2f}x)")
        for name in sorted(tob["tenants"]):
            tb = tob["tenants"][name]
            print(f"  {name}: backend={tb['backend']} "
                  f"l_shape={tb['l_shape']} requests={tb['n_requests']} "
                  f"warm={tb['warm']}")
        if args.shadow:
            st_sh = router.tenant("t1").shadow.stats()
            print(f"  shadow@t1: mirrored {st_sh['n_mirrored']} "
                  f"(rate {st_sh['sample_rate']}), overlap@{args.k} "
                  f"{st_sh['overlap_at_k']:.3f}, latency ratio "
                  f"{st_sh['latency_ratio']:.2f}")
            router.promote("t1")
            print(f"  promoted shadow -> t1 live "
                  f"(fingerprint {router.tenant('t1').fingerprint})")

    # --- obs export ------------------------------------------------------
    if args.metrics_out:
        engine.registry.write_snapshot(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        n_tr = engine.tracer.write_jsonl(args.trace_out, append=False)
        print(f"traces -> {args.trace_out} ({n_tr} sampled of "
              f"{engine.tracer.n_minted} minted)")
    return served


if __name__ == "__main__":
    main()
