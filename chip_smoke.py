"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero
exit, and nothing falls back:

  1. device   — asserts CUDA; prints the card's name and power limit;
  2. build    — builds every CUDA kernel of the port from ``csrc/`` (all
                nvcc processes started together) into ``build/kernels``;
  3. parity   — each kernel against its plain PyTorch version on the
                card: metric_topk at the CPU tests' shapes and on a gallery
                with duplicated rows (ties); dml_pair forward (loss, d2,
                proj) and gradients (kernel + closed-form backward against
                autograd through the plain version) at the CPU tests'
                shapes plus a ragged one; pairwise_sqdist at square, ragged
                and k = 1000 shapes;
  4. training — the Eq. 4 path at dml-imnet1m width (d_in 21504 -> d_out
                1000): 10,000 noisy_subspace rows and 100 classes resident
                on the card, 50k + 50k index pairs (the reference's
                RandomState draws), the example's init rescale, then
                ``train_dml_distributed`` with P = 4 workers on the card,
                1000 pairs per worker per step, sgd(inverse_time(1e-3,
                1e-3)): bsp, then local (tau 4), then ssp (staleness 2);
                checks the dml_pair launch count, finite and falling
                losses, bit-identical bsp copies and one full-width step's
                dL against the plain path; prints ms/step, pairs/s and
                one bsp step's device time by kernel;
  5. eval     — ``knn_accuracy`` of the trained L and of Euclidean on the
                2,000 held-out rows against the 8,000 training rows
                through pairwise_sqdist; checks the launch count and that
                the kernel path's predictions equal the plain path's
                except at a k-th / (k+1)-th distance tie;
  6. serving  — the exact-serving path at dml-imnet1m width (1M x 21504
                -> 1000): a random L from a seeded generator, a 1M-row
                llc_like gallery generated and projected on the card in
                blocks, ExactIndex -> RetrievalEngine -> MicroBatcher
                answering 256 single-query requests; checks the kernel's
                launch count rose and one full batch against the plain
                version; prints QPS, latency, batch size, class purity;
  7. kernels  — times each kernel, its plain version and one library call
                at the main path's shapes; prints the ``kernels`` line;
  8. the last line: ``{"ok": true, "device": {...}}``.

Every launch count is set to 0 just before a main-path phase (4, 5, 6)
and read just after; comparison launches come after the reading.

Comparison rules (kernel vs plain, both f32, different summation order).
Distances (metric_topk, pairwise_sqdist) may differ by atol + rtol *
(||a_i||^2 + ||b_j||^2) with rtol = atol = 1e-5, since f32 rounding of
an + bn - 2 a.b scales with the operands, not with their (cancelling)
difference. metric_topk ids must be equal at every rank whose plain
distance is apart from its neighbours' by more than that tolerance; at a
(near-)tie the kernel's id must have the plain distance of that rank.
dml_pair: forward outputs within rtol 2e-5 / atol 1e-5, gradients within
rtol 1e-4 / atol 1e-5 on batches with no d2 within 1e-3 of the margin
(where the hinge mask could flip); the full-width dL within rtol 1e-4 and
atol 1e-4 * max |dL|.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.dml_paper import IMNET_1M  # noqa: E402
from repro_torch.core import dml  # noqa: E402
from repro_torch.core.dml import init_params  # noqa: E402
from repro_torch.core.eval_tasks import knn_accuracy, knn_vote  # noqa: E402
from repro_torch.core.losses import dml_pair_loss  # noqa: E402
from repro_torch.core.ps import sync  # noqa: E402
from repro_torch.core.ps.trainer import (  # noqa: E402
    DMLTrainConfig, make_worker_streams, stack_worker_streams,
    train_dml_distributed)
from repro_torch.data import pairs as pairdata  # noqa: E402
from repro_torch.data.loader import partition_pairs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dml_pair import (  # noqa: E402
    dml_pair_fused, dml_pair_loss_fused, dml_pair_loss_reference,
    dml_pair_ref)
from repro_torch.kernels.metric_topk import (  # noqa: E402
    metric_sqdist_factored, metric_topk_fused, metric_topk_plain,
    project_gallery)
from repro_torch.kernels.pairwise_dist import (  # noqa: E402
    pairwise_sqdist, pairwise_sqdist_ref)
from repro_torch.obs import percentile  # noqa: E402
from repro_torch.optim import schedules, sgd  # noqa: E402
from repro_torch.serve import (ExactIndex, MicroBatcher,  # noqa: E402
                               RetrievalEngine)

RTOL = ATOL = 1e-5
PEAK_F32_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
PARITY_SHAPES = [(64, 1024, 128, 64, 10), (16, 300, 40, 12, 5),
                 (7, 129, 33, 9, 3), (200, 2048, 96, 48, 20),
                 (128, 512, 128, 128, 1), (8, 96, 24, 8, 96)]
DML_SHAPES = [(8, 8, 8), (64, 32, 48), (256, 128, 512), (100, 60, 780),
              (512, 600, 780), (32, 100, 224), (37, 16, 24)]     # (B, k, d)
PD_SHAPES = [(256, 256, 256), (64, 128, 32), (37, 129, 9),
             (300, 1000, 1000), (2000, 8000, 1000)]             # (N, M, k)
LAM = 1.3
HINGE_GAP = 1e-3
N_WORKERS = 4
TRAIN_SAMPLES, TRAIN_CLASSES, N_HOLD = 10_000, 100, 2_000
TRAIN_STEPS = {"bsp": 50, "local": 8, "ssp": 6}
KNN_K = 5
SERVE_BUCKETS = (1, 8, 64, 512)
N_REQUESTS = 256
MAX_BATCH = 64
K_TOP = 10
DEV = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- comparison -------------------------------------------------------------

def compare(L, q, gp, gn, k_top, dk, ik):
    """Hold a kernel result (dk, ik) against the plain version on the
    same inputs (rule in the module docstring). Returns max |d_k - d_p|."""
    dp, ip = metric_topk_plain(L, q, gp, gn, k_top)
    qp = q @ L.T
    qn = torch.sum(qp * qp, dim=1)
    D = metric_sqdist_factored(qp, gp, gn)              # (Nq, M) plain
    tol = ATOL + RTOL * (qn[:, None] + gn[ip.long()])
    err = (dk - dp).abs()
    assert bool((err <= tol).all()), \
        f"distances disagree: max err {err.max().item():.3e}"
    # ranks whose plain distance is apart from both neighbours' (the
    # (k_top+1)-th plain distance bounds the last rank)
    ext = torch.sort(D, dim=1, stable=True).values[:, :k_top + 1]
    if ext.shape[1] == k_top:
        ext = torch.cat([ext, torch.full_like(ext[:, :1], float("inf"))], 1)
    lo = torch.cat([torch.full_like(dp[:, :1], -float("inf")), dp[:, :-1]], 1)
    apart = ((dp - lo) > tol) & ((ext[:, 1:] - dp) > tol)
    same = ik == ip
    assert bool(same[apart].all()), "ids disagree at distinct distances"
    # near-ties: the kernel's id must carry the plain distance of its rank
    dk_plain = torch.gather(D, 1, ik.long())
    assert bool(((dk_plain - dp).abs() <= tol).all()), \
        "kernel returned a neighbour outside the tie group"
    srt = torch.sort(ik, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all()), "duplicate ids"
    return err.max().item(), int((~same).sum().item())


def _data(nq, m, d, k, seed):
    rng = np.random.RandomState(seed)
    L = torch.tensor(0.3 * rng.randn(k, d), dtype=torch.float32, device=DEV)
    q = torch.tensor(rng.randn(nq, d), dtype=torch.float32, device=DEV)
    G = torch.tensor(rng.randn(m, d), dtype=torch.float32, device=DEV)
    return L, q, G


# -- phases -----------------------------------------------------------------

def phase_device():
    assert torch.cuda.is_available(), "CUDA is not available"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    t0 = time.perf_counter()
    sources = _build.all_sources()
    libs = _build.build(sources)
    log(f"build: {len(libs)} librar(y/ies) in "
        f"{time.perf_counter() - t0:.1f}s -> {sorted(libs)}")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def phase_parity():
    for nq, m, d, k, kt in PARITY_SHAPES:
        L, q, G = _data(nq, m, d, k, seed=nq + m)
        gp, gn = project_gallery(L, G)
        dk, ik = metric_topk_fused(q, L, gp, gn, k_top=kt)
        torch.cuda.synchronize()
        err, n_diff = compare(L, q, gp, gn, kt, dk, ik)
        log(f"parity {(nq, m, d, k, kt)}: max |dd| {err:.3e}, "
            f"{n_diff} tie-resolved id differences")
    # duplicated gallery rows: every row appears 3 times, so each true
    # neighbour ties with two copies and the smaller ids must win
    L, q, G = _data(24, 200, 32, 16, seed=7)
    G = torch.cat([G, G, G])[torch.randperm(600, generator=torch.Generator(
        device="cpu").manual_seed(0)).to(DEV)]
    gp, gn = project_gallery(L, G)
    dk, ik = metric_topk_fused(q, L, gp, gn, k_top=9)
    torch.cuda.synchronize()
    err, n_diff = compare(L, q, gp, gn, 9, dk, ik)
    tied = dk[:, 1:] == dk[:, :-1]          # copies give bitwise-equal d
    assert int(tied.sum()) > 0, "no exact ties in the duplicated gallery"
    assert bool((ik[:, 1:] > ik[:, :-1])[tied].all()), \
        "equal distances not in ascending id order"
    log(f"parity duplicated rows: max |dd| {err:.3e}, {int(tied.sum())} "
        f"exact ties all smallest-id-first, {n_diff} id differences")
    for bad in (0, 257):
        try:
            metric_topk_fused(q, L, gp, gn, k_top=bad)
        except ValueError:
            continue
        raise AssertionError(f"k_top={bad} was not refused")


# -- training kernels: parity ----------------------------------------------

def _pair_data(B, k, d, seed):
    """Pairs with O(1) d2, both sim values, and a margin in the widest gap
    between consecutive d2 values of the middle half (no pair within
    HINGE_GAP of the hinge)."""
    rng = np.random.RandomState(seed)
    L = rng.randn(k, d) / np.sqrt(k * d)
    xs, ys = rng.randn(B, d), rng.randn(B, d)
    sim = (np.arange(B) % 2).astype(np.int32)
    rng.shuffle(sim)
    d2 = np.sort(np.sum(((xs - ys) @ L.T) ** 2, axis=1))
    lo = B // 4
    i = lo + int(np.argmax(np.diff(d2[lo:max(lo + 2, 3 * B // 4)])))
    margin = float(0.5 * (d2[i] + d2[i + 1]))
    assert np.min(np.abs(d2 - margin)) > HINGE_GAP
    f32 = dict(dtype=torch.float32, device=DEV)
    return (torch.tensor(L, **f32), torch.tensor(xs, **f32),
            torch.tensor(ys, **f32), torch.tensor(sim, device=DEV), margin)


def _grads(loss_fn, L, xs, ys, sim, lam, margin, wrt=3):
    """Gradients of ``loss_fn`` w.r.t. the first ``wrt`` of (L, xs, ys)."""
    args = [t.detach().clone().requires_grad_(i < wrt)
            for i, t in enumerate((L, xs, ys))]
    loss_fn(*args, sim, lam, margin).backward()
    return [a.grad for a in args[:wrt]]


def _max_err(outs, refs):
    return max(float((a - b).abs().max()) for a, b in zip(outs, refs))


def compare_dist(D, xp, yp):
    """Hold a kernel distance matrix against the plain version (distance
    rule in the module docstring). Returns (max |D - D_plain|, D_plain)."""
    D_ref = pairwise_sqdist_ref(xp, yp)
    xn, yn = torch.sum(xp * xp, 1), torch.sum(yp * yp, 1)
    err = (D - D_ref).abs()
    assert D.shape == D_ref.shape and bool((D >= 0).all())
    assert bool((err <= ATOL + RTOL * (xn[:, None] + yn[None, :])).all()), \
        f"distances disagree: max err {err.max().item():.3e}"
    return err.max().item(), D_ref


def phase_parity_training():
    for B, k, d in DML_SHAPES:
        L, xs, ys, sim, margin = _pair_data(B, k, d, seed=B + k + d)
        out = dml_pair_fused(L, xs, ys, sim, lam=LAM, margin=margin)
        ref = dml_pair_ref(L, xs, ys, sim, LAM, margin)
        gk = _grads(dml_pair_loss_fused, L, xs, ys, sim, LAM, margin)
        gp = _grads(dml_pair_loss_reference, L, xs, ys, sim, LAM, margin)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
        for a, b in zip(gk, gp):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        log(f"parity dml_pair (B, k, d) {(B, k, d)}: forward max |d| "
            f"{_max_err(out, ref):.3e}, gradient max |d| "
            f"{_max_err(gk, gp):.3e}")
    for n, m, k in PD_SHAPES:
        rng = np.random.RandomState(n + m + k)
        xp = torch.tensor(rng.randn(n, k), dtype=torch.float32, device=DEV)
        yp = torch.tensor(rng.randn(m, k), dtype=torch.float32, device=DEV)
        err, _ = compare_dist(pairwise_sqdist(xp, yp), xp, yp)
        log(f"parity pairwise_sqdist (N, M, k) {(n, m, k)}: max |dD| "
            f"{err:.3e}")


# -- training at dml-imnet1m width ------------------------------------------

class IndexPairs:
    """Index pairs over a feature store resident on the card, as a pair
    source of ``train_dml_distributed``: partitioned over workers (paper
    §4.1), each worker's batches gathered on the card by index."""

    def __init__(self, features, idx):
        self.features, self.idx = features, idx

    def worker_streams(self, n_workers, batch_size, seed):
        return [pairdata.pair_batches_from_indices(
            self.features, shard, batch_size, seed=seed + i, device=DEV)
            for i, shard in enumerate(partition_pairs(self.idx, n_workers))]


def _reset_counts():
    for fn in (dml_pair_fused, pairwise_sqdist, metric_topk_fused):
        fn.launches = 0


def phase_training(exp=IMNET_1M):
    cfg = exp.dml
    t0 = time.perf_counter()
    feats_np, labels = pairdata.make_features(pairdata.PairDatasetConfig(
        n_samples=TRAIN_SAMPLES, feat_dim=cfg.feat_dim,
        n_classes=TRAIN_CLASSES, kind="noisy_subspace", noise=0.8, seed=0))
    train_idx = pairdata.sample_pair_indices(labels[:-N_HOLD], 50_000,
                                             50_000, seed=1)
    feats = torch.from_numpy(feats_np).to(DEV)
    del feats_np
    train_x = feats[:-N_HOLD]
    torch.cuda.synchronize()
    log(f"training data: {TRAIN_SAMPLES} x {cfg.feat_dim} noisy_subspace "
        f"rows ({feats.numel() * 4 / 1e9:.2f} GB on the card), "
        f"{TRAIN_CLASSES} classes, 50k + 50k index pairs over the first "
        f"{TRAIN_SAMPLES - N_HOLD} rows, in {time.perf_counter() - t0:.1f}s")

    # the example's scale-aware init: initial ||Lz||^2 ~ 2 * margin
    L = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    probe = next(pairdata.pair_batches_from_indices(
        train_x, train_idx, 256, seed=99, device=DEV))
    d2 = float(torch.mean(dml.mahalanobis_sqdist(L, probe["xs"],
                                                 probe["ys"])))
    L = L * float(np.sqrt(2.0 * cfg.margin / max(d2, 1e-9)))
    log(f"init rescale: mean d2 {d2:.1f} -> ~{2 * cfg.margin}")

    source = IndexPairs(train_x, train_idx)
    opt = sgd(schedules.inverse_time(1e-3, 1e-3))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                         # counts of the main path only
    histories, step_ms = {}, {}
    for mode, steps in TRAIN_STEPS.items():
        ps = sync.PSConfig(n_workers=N_WORKERS, sync=mode, tau=4,
                           staleness=2)
        tcfg = DMLTrainConfig(dml=cfg, ps=ps, batch_size=exp.batch_size,
                              steps=steps, log_every=1)
        L, hist = train_dml_distributed(
            tcfg, source, opt=opt, L0=L,
            step_hook=lambda t, _L: time.perf_counter())
        stamps = [h["hook"] for h in hist]
        step_ms[mode] = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
        histories[mode] = [h["loss"] for h in hist]
        log(f"train {mode}: {steps} steps, loss {histories[mode][0]:.4f} "
            f"-> {histories[mode][-1]:.4f}; {step_ms[mode]:.2f} ms/step "
            f"after the first (host clock, each step ends in a sync), "
            f"{N_WORKERS * exp.batch_size / step_ms[mode] * 1e3:.0f} "
            f"pairs/s")
    # bsp keeps worker copies bit-identical (two more main-path steps)
    ps = sync.PSConfig(n_workers=N_WORKERS, sync="bsp")
    state = sync.init_state(opt, L, ps)
    step = sync.make_train_step(
        lambda p, b: dml_pair_loss(p, b, lam=cfg.lam, margin=cfg.margin),
        opt, ps)
    batches = stack_worker_streams(make_worker_streams(
        source, N_WORKERS, exp.batch_size, seed=5))
    for _ in range(2):
        state, _ = step(state, next(batches))
    torch.cuda.synchronize()
    launches = dml_pair_fused.launches
    n_steps = sum(TRAIN_STEPS.values()) + 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(torch.equal(state.params[0], state.params[w])
               for w in range(1, N_WORKERS)), "bsp copies differ"
    assert launches >= N_WORKERS * n_steps, \
        f"dml_pair launched {launches} times in {n_steps} steps"
    assert all(np.isfinite(v).all() for v in histories.values())
    bsp = histories["bsp"]
    assert np.mean(bsp[-5:]) < bsp[0], "the bsp loss did not fall"
    log(f"training: dml_pair launches {launches} in {n_steps} steps "
        f"({launches / n_steps:.1f} per step, P = {N_WORKERS}); bsp copies "
        f"bit-identical; peak memory {peak_gb:.2f} GB")
    step_parts = step_profile(lambda: step(state, next(batches)),
                              step_ms["bsp"])

    # one full-width step's dL, kernel path against plain path, on a batch
    # with no pair within HINGE_GAP of the margin
    batch = next(pairdata.pair_batches_from_indices(
        train_x, train_idx, exp.batch_size, seed=7, device=DEV))
    xs, ys, sim = batch["xs"], batch["ys"], batch["sim"]
    _, d2_plain, _ = dml_pair_ref(L, xs, ys, sim, cfg.lam, cfg.margin)
    keep = (d2_plain - cfg.margin).abs() > HINGE_GAP
    xs, ys, sim = xs[keep].contiguous(), ys[keep].contiguous(), sim[keep]
    (dk,) = _grads(dml_pair_loss_fused, L, xs, ys, sim, cfg.lam, cfg.margin,
                   wrt=1)
    (dp,) = _grads(dml_pair_loss_reference, L, xs, ys, sim, cfg.lam,
                   cfg.margin, wrt=1)
    scale = float(dp.abs().max())
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4 * scale)
    log(f"full-width dL ({int(keep.sum())} of {exp.batch_size} pairs, "
        f"{exp.batch_size - int(keep.sum())} within {HINGE_GAP} of the "
        f"margin left out): max |dL_kernel - dL_plain| "
        f"{float((dk - dp).abs().max()):.3e} (max |dL| {scale:.3e})")
    out = dml_pair_fused(L, batch["xs"], batch["ys"], batch["sim"],
                         lam=cfg.lam, margin=cfg.margin)
    ref = dml_pair_ref(L, batch["xs"], batch["ys"], batch["sim"], cfg.lam,
                       cfg.margin)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5)
    return {"L": L, "feats": feats, "labels": labels, "batch": batch,
            "launches": launches, "launches_per_step": launches / n_steps,
            "max_err": _max_err(out, ref), "step_ms": step_ms,
            "step_parts": step_parts, "losses": histories, "peak_gb": peak_gb}


# -- kNN evaluation -----------------------------------------------------------

def phase_eval(L, feats, labels):
    d_in = feats.shape[1]
    train_x, test_x = feats[:-N_HOLD], feats[-N_HOLD:]
    y = torch.from_numpy(labels).to(DEV)
    train_y, test_y = y[:-N_HOLD], y[-N_HOLD:]
    torch.cuda.synchronize()
    _reset_counts()                         # counts of the main path only
    t0 = time.perf_counter()
    acc = {"learned": knn_accuracy(L, train_x, train_y, test_x, test_y,
                                   k=KNN_K),
           "euclidean": knn_accuracy(None, train_x, train_y, test_x, test_y,
                                     k=KNN_K)}
    wall = time.perf_counter() - t0
    launches = pairwise_sqdist.launches
    assert launches >= 2, f"pairwise_sqdist launched {launches} times"
    log(f"kNN@{KNN_K} accuracy on {N_HOLD} held-out rows against "
        f"{TRAIN_SAMPLES - N_HOLD} training rows: learned "
        f"{acc['learned']:.4f}, euclidean {acc['euclidean']:.4f} "
        f"(chance {1 / TRAIN_CLASSES:.3f}); {launches} pairwise_sqdist "
        f"launches; {wall:.2f}s for both (host clock)")

    # the kernel path's predictions against the plain path's
    errs, proj = {}, {}
    for name, M in (("learned", L), ("euclidean", None)):
        M = torch.eye(d_in, device=DEV) if M is None else M
        xp, xn = project_gallery(M, test_x)
        yp, yn = project_gallery(M, train_x)
        D = pairwise_sqdist(xp, yp)
        errs[name], D_ref = compare_dist(D, xp, yp)
        pk, pp = knn_vote(D, train_y, KNN_K), knn_vote(D_ref, train_y, KNN_K)
        rows = torch.nonzero(pk != pp).flatten()
        if len(rows):
            srt = torch.sort(D_ref[rows], dim=1, stable=True)
            gap = srt.values[:, KNN_K] - srt.values[:, KNN_K - 1]
            tol = ATOL + RTOL * (xn[rows] + torch.maximum(
                yn[srt.indices[:, KNN_K]], yn[srt.indices[:, KNN_K - 1]]))
            assert bool((gap <= tol).all()), \
                f"{name}: predictions differ away from a k-th distance tie"
        log(f"eval {name}: kernel vs plain max |dD| {errs[name]:.3e}; "
            f"{len(rows)} of {N_HOLD} predictions differ, each at a "
            f"k-th / (k+1)-th distance tie")
        proj[name] = (xp, yp)
    return {"acc": acc, "launches": launches, "max_err": errs["learned"],
            "xp": proj["learned"][0], "yp": proj["learned"][1]}


def make_gallery(gen, n, d_in, n_classes, L, query_rows, block=16384,
                 noise=0.3, sparsity=0.9):
    """llc_like rows (make_features' recipe: class support masks, |center|
    magnitudes, masked |noise|) generated on the card block by block and
    projected through L; the raw rows never stay resident. Returns
    (gp, gn, labels, raw rows at ``query_rows``)."""
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=DEV)
    centers = torch.randn((n_classes, d_in), generator=gen, device=DEV)
    masks = torch.rand((n_classes, d_in), generator=gen,
                       device=DEV) < (1.0 - sparsity)
    mags = centers.abs() * masks
    gp = torch.empty((n, L.shape[0]), dtype=torch.float32, device=DEV)
    gn = torch.empty((n,), dtype=torch.float32, device=DEV)
    raw_q = torch.empty((len(query_rows), d_in), device=DEV)
    qrows = torch.as_tensor(query_rows, device=DEV)
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        lab = labels[b0:b1]
        x = mags[lab] + noise * torch.randn(
            (b1 - b0, d_in), generator=gen, device=DEV).abs() * masks[lab]
        gp[b0:b1], gn[b0:b1] = project_gallery(L, x)
        hit = (qrows >= b0) & (qrows < b1)
        raw_q[hit] = x[qrows[hit] - b0]
        del x
    return gp, gn, labels, raw_q


def span_means(traces):
    """Mean duration in ms of each span name over finished trace dicts."""
    tot, cnt = {}, {}

    def walk(sp):
        if sp.get("t_end") is not None:
            tot[sp["name"]] = tot.get(sp["name"], 0.0) + \
                sp["t_end"] - sp["t_start"]
            cnt[sp["name"]] = cnt.get(sp["name"], 0) + 1
        for c in sp.get("children", ()):
            walk(c)

    for tr in traces:
        walk(tr["root"])
    return {k: round(1e3 * tot[k] / cnt[k], 3) for k in sorted(tot)}


def phase_serving(exp=IMNET_1M):
    cfg = exp.dml
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = init_params(cfg, gen, DEV)
    rng = np.random.RandomState(1)
    qids = rng.randint(0, exp.n_samples, N_REQUESTS)
    t0 = time.perf_counter()
    gp, gn, labels, raw_q = make_gallery(gen, exp.n_samples, cfg.feat_dim,
                                         exp.n_classes, L, qids)
    index = ExactIndex.from_projected(L, gp, gn)
    torch.cuda.synchronize()
    log(f"serving: {exp.name} gallery {index.size} x {cfg.feat_dim} -> "
        f"{cfg.proj_dim} generated+projected in "
        f"{time.perf_counter() - t0:.1f}s "
        f"(gp {gp.numel() * 4 / 1e9:.2f} GB on the card)")
    queries = raw_q + 0.1 * torch.randn(raw_q.shape, generator=gen,
                                        device=DEV)
    queries_np = queries.cpu().numpy()

    engine = RetrievalEngine(index, k_top=K_TOP, buckets=SERVE_BUCKETS)
    t0 = time.perf_counter()
    engine.warmup()
    log(f"warmup over buckets {SERVE_BUCKETS}: "
        f"{time.perf_counter() - t0:.2f}s")
    front = MicroBatcher(engine, max_batch=MAX_BATCH, max_wait_ms=2.0)

    engine.tracer.sample_rate = 1.0         # every request's span tree
    metric_topk_fused.launches = 0          # counts of the main path only
    t0 = time.perf_counter()
    pending = [(time.perf_counter(), front.submit(queries_np[i]))
               for i in range(N_REQUESTS)]
    lat, nbrs = [], []
    for t_sub, fut in pending:
        _, nbr = fut.result(timeout=300)
        lat.append(time.perf_counter() - t_sub)
        nbrs.append(nbr)
    wall = time.perf_counter() - t0
    launches = metric_topk_fused.launches
    assert front.close(), "batcher worker did not stop"
    assert launches > 0, "the serving path never launched the kernel"

    nbrs = np.stack(nbrs)
    labels_np = labels.cpu().numpy()
    purity = float(np.mean(labels_np[nbrs] == labels_np[qids][:, None]))
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50, p99 = percentile(lat_ms, (50.0, 99.0))
    st = engine.stats()
    log(f"served {N_REQUESTS} requests in {wall:.3f}s: qps "
        f"{N_REQUESTS / wall:.1f} (device-side {st['qps']:.1f}), latency "
        f"ms p50 {p50:.2f} p99 {p99:.2f}, batches {front.n_batches} mean "
        f"{np.mean(front.batch_sizes):.1f}, kernel launches {launches}, "
        f"backend {st['backend']}")
    log(f"neighbour class purity@{K_TOP}: {purity:.3f} "
        f"(chance {1.0 / exp.n_classes:.3f})")
    spans = span_means(engine.tracer.drain())
    log(f"mean span ms (host clock): {spans}")
    assert np.isfinite(lat_ms).all() and st["backend"] == "cuda"
    assert purity > 10.0 / exp.n_classes, "purity at chance level"

    # one full batch, kernel against plain on the card
    qb = queries[:MAX_BATCH].contiguous()
    dk, ik = index.topk(qb, K_TOP)
    torch.cuda.synchronize()
    assert torch.isfinite(dk).all() and dk.shape == (MAX_BATCH, K_TOP)
    err, n_diff = compare(L, qb, gp, gn, K_TOP, dk, ik)
    log(f"full batch vs plain: max |dd| {err:.3e}, {n_diff} tie-resolved "
        f"id differences")
    serving = {"qps": N_REQUESTS / wall, "p50_ms": p50, "p99_ms": p99,
               "spans_ms": spans,
               "mean_batch": float(np.mean(front.batch_sizes)),
               "purity": purity, "launches": launches}
    return index, queries, serving, err


def _time(fn, iters):
    fn()                                       # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(ops, nbytes):
    """(least ms for ``ops`` f32 FLOP and ``nbytes`` moved, what bounds it)"""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound(nq, d_in, d_out, m, k_top):
    ops = 2.0 * nq * d_in * d_out + 2.0 * nq * m * d_out
    nbytes = 4.0 * (nq * d_in + d_out * d_in + m * d_out + m
                    + 2 * nq * k_top)
    return roofline(ops, nbytes)


def library(L, q, gp, gn, k_top):
    """One PyTorch call chain for the same function (yardstick only)."""
    qp = q @ L.T
    d = torch.sum(qp * qp, 1)[:, None] + gn[None, :] - 2.0 * (qp @ gp.T)
    return torch.topk(d.clamp_min_(0.0), k_top, dim=1, largest=False)


def device_breakdown(fn):
    """Device milliseconds by kernel name over one call (torch.profiler);
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        ms = (getattr(ev, "device_time_total", 0) or 0) / 1e3
        if ms <= 0:
            continue
        key = ev.key.replace("(anonymous namespace)::", "")
        m = re.search(r"([A-Za-z_]\w*(?:<[^>]*>)?)\(", key)
        name = m.group(1) if m else key[:40]
        out[name] = round(out.get(name, 0.0) + ms, 4)
    return out or None


def step_profile(fn, step_ms, top=6):
    """Device ms by kernel over one training step (the largest ``top``
    kernels, the rest as ``other``) and the device's idle share of the
    step time measured on the host clock; single stream, so the kernel
    times add up."""
    parts = device_breakdown(fn)
    if parts is None:
        log("one bsp step on the card: device time not measured")
        return None
    busy = sum(parts.values())
    out = dict(sorted(parts.items(), key=lambda kv: -kv[1])[:top])
    out["other"] = round(busy - sum(out.values()), 4)
    log(f"one bsp step on the card: device busy {busy:.3f} ms of "
        f"{step_ms:.3f} ms per step (host clock), idle share "
        f"{1 - busy / step_ms:.1%}; device ms by kernel {out}")
    return {"busy_ms": round(busy, 4), "by_kernel": out}


def phase_kernels(index, queries, launches, max_err):
    L, gp, gn = index.L, index.gp, index.gn
    d_out, d_in = L.shape
    m = gp.shape[0]
    rows = {}
    for nq in (1, MAX_BATCH):
        q = queries[:nq].contiguous()
        ms = _time(lambda: metric_topk_fused(q, L, gp, gn, k_top=K_TOP), 10)
        plain_ms = _time(lambda: metric_topk_plain(L, q, gp, gn, K_TOP), 3)
        lib_ms = _time(lambda: library(L, q, gp, gn, K_TOP), 3)
        b_ms, b_by = bound(nq, d_in, d_out, m, K_TOP)
        parts = device_breakdown(
            lambda: metric_topk_fused(q, L, gp, gn, k_top=K_TOP))
        rows[nq] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms,
                        breakdown_ms=parts)
        log(f"metric_topk Nq={nq} M={m} d_in={d_in} d_out={d_out} "
            f"k={K_TOP}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
            f"{b_ms / ms:.1%} of bound; device ms by kernel "
            f"{parts if parts else 'not measured'}")
    main = rows[MAX_BATCH]
    return {"name": "metric_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/metric_topk/csrc/"
                      "metric_topk.cu",
            "replaces": "src/repro/kernels/metric_topk/kernel.py:103",
            "launches": launches, "max_abs_err": max_err,
            **main,
            "shape": {"nq": MAX_BATCH, "m": m, "d_in": d_in,
                      "d_out": d_out, "k_top": K_TOP},
            "at_nq1": rows[1]}


def library_pair(L, xs, ys, sim, lam, margin):
    """PyTorch calls for the Eq. 4 forward (yardstick only)."""
    proj = torch.matmul(xs - ys, L.T)
    d2 = torch.sum(proj * proj, 1)
    simf = sim.to(torch.float32)
    return simf * d2 + (1 - simf) * lam * torch.clamp_min(margin - d2, 0.0)


def library_pairwise(xp, yp):
    """PyTorch calls for the all-pairs distances (yardstick only)."""
    xn, yn = torch.sum(xp * xp, 1), torch.sum(yp * yp, 1)
    return (xn[:, None] + yn[None, :]
            - 2.0 * torch.matmul(xp, yp.T)).clamp_min_(0.0)


def _backward(loss_fn, L, xs, ys, sim, lam, margin):
    _grads(loss_fn, L, xs, ys, sim, lam, margin, wrt=1)


def time_dml_pair(L, batch, launches, launches_per_step, max_err,
                  cfg=IMNET_1M.dml):
    xs, ys, sim = batch["xs"], batch["ys"], batch["sim"]
    (B, d), k = xs.shape, L.shape[0]
    args = (L, xs, ys, sim, cfg.lam, cfg.margin)
    fwd = lambda: dml_pair_fused(*args[:4], lam=cfg.lam,  # noqa: E731
                                 margin=cfg.margin)
    ms = _time(fwd, 10)
    plain_ms = _time(lambda: dml_pair_ref(*args), 10)
    lib_ms = _time(lambda: library_pair(*args), 10)
    fb_ms = _time(lambda: _backward(dml_pair_loss_fused, *args), 5)
    plain_fb_ms = _time(lambda: _backward(dml_pair_loss_reference, *args), 5)
    b_ms, b_by = roofline(2.0 * B * d * k,
                          4.0 * (2 * B * d + k * d + B + 2 * B + B * k))
    parts = device_breakdown(fwd)
    log(f"dml_pair B={B} d={d} k={k}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}), {b_ms / ms:.1%} of bound; forward+backward(L) kernel "
        f"path {fb_ms:.3f} ms, plain {plain_fb_ms:.3f} ms; device ms by "
        f"kernel {parts if parts else 'not measured'}")
    return {"name": "dml_pair", "route": "cuda",
            "source": "src/repro_torch/kernels/dml_pair/csrc/dml_pair.cu",
            "replaces": "src/repro/kernels/dml_pair/kernel.py:79",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "breakdown_ms": parts,
            "fwd_bwd_ms": fb_ms, "plain_fwd_bwd_ms": plain_fb_ms,
            "launches_per_step": launches_per_step,
            "shape": {"B": B, "d_in": d, "d_out": k}}


def time_pairwise(xp, yp, launches, max_err):
    (n, k), m = xp.shape, yp.shape[0]
    ms = _time(lambda: pairwise_sqdist(xp, yp), 10)
    plain_ms = _time(lambda: pairwise_sqdist_ref(xp, yp), 10)
    lib_ms = _time(lambda: library_pairwise(xp, yp), 10)
    b_ms, b_by = roofline(2.0 * n * m * k, 4.0 * (n * k + m * k + n * m))
    parts = device_breakdown(lambda: pairwise_sqdist(xp, yp))
    log(f"pairwise_sqdist N={n} M={m} k={k}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}), {b_ms / ms:.1%} of bound; device ms by kernel "
        f"{parts if parts else 'not measured'}")
    return {"name": "pairwise_sqdist", "route": "cuda",
            "source": "src/repro_torch/kernels/pairwise_dist/csrc/"
                      "pairwise_dist.cu",
            "replaces": "src/repro/kernels/pairwise_dist/kernel.py:52",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "breakdown_ms": parts,
            "shape": {"N": n, "M": m, "k": k}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_parity()
    phase_parity_training()
    train = phase_training()
    ev = phase_eval(train["L"], train["feats"], train["labels"])
    entries = [time_dml_pair(train["L"], train["batch"], train["launches"],
                             train["launches_per_step"], train["max_err"]),
               time_pairwise(ev["xp"], ev["yp"], ev["launches"],
                             ev["max_err"])]
    entries[0]["train_step"] = {"ms": train["step_ms"]["bsp"],
                                "device": train["step_parts"]}
    del train, ev
    torch.cuda.empty_cache()
    index, queries, serving, err = phase_serving()
    entries.insert(0, phase_kernels(index, queries, serving["launches"],
                                    err))
    print(json.dumps({"kernels": entries}), flush=True)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
