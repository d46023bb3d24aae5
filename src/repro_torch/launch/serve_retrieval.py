"""Metric-retrieval serving launcher (exact / IVF / IVFPQ, micro-batched).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_retrieval \
          [--gallery-size 20000] [--train-steps 200] [--requests 500] \
          [--index exact|ivf|ivfpq] [--n-clusters 64] [--nprobe 8] \
          [--n-subspaces 8] [--bits 8] [--rerank-depth 50] \
          [--pq-store device|host] [--scan-impl auto] [--device cpu]

Counterpart of ``repro.launch.serve_retrieval`` for the single-device
index paths: builds a class-structured gallery (data.pairs), learns the
metric factor L with ``train_dml_single`` on held-out-split pairs (Eq. 4
through the ``dml_pair`` kernel on the card; ``--train-steps 0`` keeps a
random L), stands up the index (ExactIndex on metric_topk, IVFIndex on
ivf_scan or IVFPQIndex on pq_adc) -> RetrievalEngine -> MicroBatcher,
fires single-query traffic through the batcher and reports QPS, latency
percentiles, batch coalescing, the cache and neighbor class purity.
Runs on the card unless ``--device cpu`` is given. The reference's
mutable, snapshot, scheduler, tenant, mining and sharding flags are not
ported.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import dml
from repro_torch.core.ps.trainer import train_dml_single
from repro_torch.data import pairs as pairdata
from repro_torch.device import resolve_device
from repro_torch.obs import percentile
from repro_torch.serve import (ExactIndex, IVFIndex, IVFPQIndex,
                               MicroBatcher, RetrievalEngine)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernel's plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- data + metric ---------------------------------------------------
    cfg = pairdata.PairDatasetConfig(
        n_samples=args.gallery_size, feat_dim=args.feat_dim,
        n_classes=args.n_classes, kind="noisy_subspace", noise=0.5, seed=0)
    feats, labels = pairdata.make_features(cfg)
    if args.l_rank is not None:         # low-rank knob wins over proj-dim
        args.proj_dim = args.l_rank
    dcfg = dml.DMLConfig(feat_dim=args.feat_dim, l_rank=args.proj_dim)
    if args.train_steps > 0:
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

    # --- serving stack ---------------------------------------------------
    ivf_kw = dict(n_clusters=args.n_clusters, nprobe=args.nprobe,
                  scan_impl=args.scan_impl)
    t0 = time.perf_counter()
    gallery = torch.from_numpy(feats)
    if args.index == "ivfpq":
        index = IVFPQIndex.build(
            L, gallery, n_subspaces=args.n_subspaces, bits=args.bits,
            rerank_depth=args.rerank_depth, store=args.pq_store,
            device=device, **ivf_kw)
    elif args.index == "ivf":
        index = IVFIndex.build(L, gallery, device=device, **ivf_kw)
    else:
        index = ExactIndex.build(L, gallery, device=device)
    build_s = time.perf_counter() - t0
    engine = RetrievalEngine(index, k_top=args.k,
                             cache_size=args.cache_size)
    engine.warmup()
    print(f"index[{type(index).__name__}]: {index.size} x {args.proj_dim} "
          f"on {device} ({engine.backend} path), built+projected in "
          f"{build_s:.2f}s")
    if isinstance(index, (IVFIndex, IVFPQIndex)):
        scanned = index.nprobe * index.cap
        print(f"  {type(index).__name__}: {index.n_clusters} clusters, cap "
              f"{index.cap}, nprobe {index.nprobe} -> <= {scanned} of "
              f"{index.size} rows scanned per query "
              f"({scanned / max(index.size, 1):.1%}); "
              f"scan_impl={index.scan_impl} (resolves to "
              f"{scan.resolve_scan_impl(index.scan_impl, device=device)})")
    if isinstance(index, IVFPQIndex):
        print(f"  pq: {index.pq.n_subspaces} x {index.pq.bits}-bit codes "
              f"({index.code_bytes_per_row} B/row scanned vs "
              f"{4 * args.proj_dim + 4} full precision, "
              f"{index.compression_ratio:.1f}x), rerank depth "
              f"{index.rerank_depth}, store={index.store}")
    front = MicroBatcher(engine, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms)

    # --- traffic ---------------------------------------------------------
    rng = np.random.RandomState(1)
    qids = rng.randint(0, len(feats), args.requests)
    noisy = feats[qids] + 0.1 * rng.randn(args.requests, args.feat_dim) \
        .astype(np.float32)
    t0 = time.perf_counter()
    pending = []
    for i, qid in enumerate(qids):
        pending.append((qid, time.perf_counter(), front.submit(noisy[i])))
    lat, purity = [], []
    for qid, t_sub, fut in pending:
        _, nbr = fut.result(timeout=60)
        lat.append(time.perf_counter() - t_sub)
        purity.append(float(np.mean(labels[np.asarray(nbr)] == labels[qid])))
    wall = time.perf_counter() - t0
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


if __name__ == "__main__":
    main()
