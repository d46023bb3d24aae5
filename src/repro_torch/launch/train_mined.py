"""Closed-loop mined-pair training launcher.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_mined \
          [--steps 150] [--refresh-every 15] [--max-mined-frac 0.7] \
          [--index mutable-exact|mutable-ivf|exact|ivf] [--baseline] \
          [--device cpu]

Counterpart of ``repro.launch.train_mined``: stands up the closed loop on
synthetic noisy_subspace data — a MutableIndex over the train rows (or a
frozen index that each refresh rebuilds) behind a RetrievalEngine warmed
for the miner's k, and ``ClosedLoopTrainer`` alternating PS training with
``swap_metric`` refreshes and ``HardPairMiner`` sweeps, the mined pairs
feeding back into the worker batch streams under a curriculum. Reports
the kNN-accuracy trace (``knn_accuracy`` on ``pairwise_sqdist``), the
per-refresh mining yield and the engine's serving stats. On the card the
PS steps run ``dml_pair``, the mining sweeps ``metric_topk`` (exact
indexes) or ``ivf_scan`` (IVF ones). Runs on the card unless ``--device
cpu`` is given, and raises without one.

``--baseline`` also runs the uniform-sampling trainer at the same batch
size for the full step budget, for a side-by-side trace.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-samples", type=int, default=8000)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--proj-dim", type=int, default=16)
    ap.add_argument("--l-rank", type=int, default=None,
                    help="low-rank d_out of the trained rectangular L; "
                         "overrides --proj-dim")
    ap.add_argument("--n-classes", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--sync", choices=["bsp", "local", "ssp"],
                    default="bsp")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    # mining knobs
    ap.add_argument("--index", choices=["mutable-exact", "mutable-ivf",
                                        "exact", "ivf"],
                    default="mutable-exact",
                    help="serving backend the miner queries (mutable-* "
                         "refresh via swap_metric; frozen kinds rebuild)")
    ap.add_argument("--n-clusters", type=int, default=64,
                    help="ivf backends: gallery segments")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="ivf backends: clusters scanned per query")
    ap.add_argument("--k-neighbors", type=int, default=20)
    ap.add_argument("--margin", type=float, default=1.0)
    ap.add_argument("--max-negatives", type=int, default=1)
    ap.add_argument("--max-positives", type=int, default=3)
    ap.add_argument("--refresh-every", type=int, default=15,
                    help="index refresh + re-mine period (steps)")
    ap.add_argument("--plateau-window", type=int, default=0,
                    help=">0: also refresh when the loss plateaus over "
                         "this many trailing steps")
    ap.add_argument("--mine-queries", type=int, default=0,
                    help="anchors per refresh (0 = every train row)")
    ap.add_argument("--warmup-steps", type=int, default=10)
    ap.add_argument("--ramp-steps", type=int, default=20)
    ap.add_argument("--max-mined-frac", type=float, default=0.7)
    ap.add_argument("--baseline", action="store_true",
                    help="also run the uniform-sampling trainer for "
                         "comparison")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.core import dml, eval_tasks
    from repro_torch.core.ps import sync
    from repro_torch.core.ps.trainer import (DMLTrainConfig,
                                             train_dml_distributed)
    from repro_torch.data import pairs as pairdata
    from repro_torch.device import resolve_device
    from repro_torch.mining import (ClosedLoopConfig, ClosedLoopTrainer,
                                    CurriculumSchedule, MinerConfig)

    device = resolve_device(args.device)
    cfg = pairdata.PairDatasetConfig(
        n_samples=args.n_samples, feat_dim=args.feat_dim,
        n_classes=args.n_classes, kind="noisy_subspace",
        noise=args.noise, seed=args.seed)
    x, y = pairdata.make_features(cfg)
    n_tr = int(args.n_samples * 0.8)
    tr_x, tr_y, te_x, te_y = x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]
    # the eval rows live on the device once; every hook call reuses them
    ev = [torch.from_numpy(a).to(device) for a in (tr_x, tr_y, te_x, te_y)]

    def hook(t, L):
        return eval_tasks.knn_accuracy(L, *ev, k=5, device=device)

    tcfg = DMLTrainConfig(
        dml=dml.DMLConfig(
            feat_dim=args.feat_dim,
            l_rank=(args.l_rank if args.l_rank is not None
                    else args.proj_dim)),
        ps=sync.PSConfig(n_workers=args.workers, sync=args.sync,
                         seed=args.seed),
        batch_size=args.batch, steps=args.steps, lr=args.lr,
        log_every=args.eval_every)
    ikw = (dict(n_clusters=args.n_clusters, nprobe=args.nprobe)
           if "ivf" in args.index else None)
    ccfg = ClosedLoopConfig(
        train=tcfg,
        miner=MinerConfig(k_neighbors=args.k_neighbors,
                          margin=args.margin,
                          max_negatives=args.max_negatives,
                          max_positives=args.max_positives),
        schedule=CurriculumSchedule(warmup_steps=args.warmup_steps,
                                    ramp_steps=args.ramp_steps,
                                    max_mined_frac=args.max_mined_frac),
        index=args.index, index_kwargs=ikw,
        refresh_every=args.refresh_every,
        plateau_window=args.plateau_window,
        mine_queries=args.mine_queries or n_tr)

    trainer = ClosedLoopTrainer(ccfg, ev[0], tr_y, device=device)
    print(f"closed loop: {args.index} index over {n_tr} rows on {device}, "
          f"refresh every {args.refresh_every} steps, "
          f"mine {ccfg.mine_queries} anchors/refresh, "
          f"curriculum {args.warmup_steps}+{args.ramp_steps} -> "
          f"{args.max_mined_frac:.0%} mined")
    L, hist = trainer.run(step_hook=hook)

    print("\nstep,loss,knn_acc,staleness,mined_frac")
    for h in hist["steps"]:
        print(f"{h['step']},{h['loss']:.4f},{h['hook']:.4f},"
              f"{h['staleness']},{h['mined_frac']:.2f}")
    print("\nrefresh,step,n_pairs,neg_yield,pos_yield,engine_qps")
    for r in hist["refreshes"]:
        print(f"{r['refresh']},{r['step']},{r['n_pairs']},"
              f"{r['neg_yield']:.2f},{r['pos_yield']:.2f},"
              f"{r['engine_qps']:.0f}")
    s = hist["summary"]
    est = s["engine"]
    print(f"\n{s['n_refreshes']} refreshes, mean staleness "
          f"{s['mean_staleness']:.1f} steps, {s['total_mined_pairs']} "
          f"pairs mined")
    print(f"engine[{est['index']}]: {est['qps']:.0f} qps over "
          f"{est['n_device_queries']} mining queries "
          f"({est['cache_hits']} cache hits), gallery "
          f"{est['gallery_size']} rows, {est['backend']} path")
    print(f"final kNN accuracy (mined, {args.steps} steps): "
          f"{hist['steps'][-1]['hook']:.4f}")

    if args.baseline:
        idx = pairdata.sample_pair_indices(tr_y, 20000, 20000,
                                           seed=args.seed + 1)
        uni = {"xs": tr_x[idx["a"]], "ys": tr_x[idx["b"]],
               "sim": idx["sim"]}
        _, hist_u = train_dml_distributed(tcfg, uni, step_hook=hook,
                                          device=device)
        print(f"final kNN accuracy (uniform, {args.steps} steps): "
              f"{hist_u[-1]['hook']:.4f}")


if __name__ == "__main__":
    main()
