"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a non-zero
exit, and nothing falls back:

  1. device   — asserts CUDA; prints the card's name and power limit;
  2. build    — builds every CUDA kernel of the port from ``csrc/`` (all
                nvcc processes started together) into ``build/kernels``;
  3. parity   — the metric_topk kernel against its plain PyTorch version
                on the card at the CPU tests' shapes and on a gallery with
                duplicated rows (ties);
  4. serving  — the exact-serving path at dml-imnet1m width (1M x 21504
                -> 1000): a random L from a seeded generator, a 1M-row
                llc_like gallery generated and projected on the card in
                blocks, ExactIndex -> RetrievalEngine -> MicroBatcher
                answering 256 single-query requests; checks the kernel's
                launch count rose and one full batch against the plain
                version; prints QPS, latency, batch size, class purity;
  5. kernels  — times each kernel, its plain version and one library call
                at the main path's shapes; prints the ``kernels`` line;
  6. the last line: ``{"ok": true, "device": {...}}``.

Comparison rule (kernel vs plain, both f32, different summation order):
a distance may differ by atol + rtol * (qn_i + gn_j) with rtol = atol =
1e-5, since f32 rounding of qn + gn - 2 qp.gp scales with the operands,
not with their (cancelling) difference. Ids must be equal at every rank
whose plain distance is apart from its neighbours' by more than that
tolerance; at a (near-)tie the kernel's id must have the plain distance
of that rank.
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
from repro_torch.core.dml import init_params  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.metric_topk import (  # noqa: E402
    metric_sqdist_factored, metric_topk_fused, metric_topk_plain,
    project_gallery)
from repro_torch.obs import percentile  # noqa: E402
from repro_torch.serve import (ExactIndex, MicroBatcher,  # noqa: E402
                               RetrievalEngine)

RTOL = ATOL = 1e-5
PEAK_F32_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
PARITY_SHAPES = [(64, 1024, 128, 64, 10), (16, 300, 40, 12, 5),
                 (7, 129, 33, 9, 3), (200, 2048, 96, 48, 20),
                 (128, 512, 128, 128, 1), (8, 96, 24, 8, 96)]
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


def bound(nq, d_in, d_out, m, k_top):
    ops = 2.0 * nq * d_in * d_out + 2.0 * nq * m * d_out
    nbytes = 4.0 * (nq * d_in + d_out * d_in + m * d_out + m
                    + 2 * nq * k_top)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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
    entry = {"name": "metric_topk", "route": "cuda",
             "source": "src/repro_torch/kernels/metric_topk/csrc/"
                       "metric_topk.cu",
             "replaces": "src/repro/kernels/metric_topk/kernel.py:103",
             "launches": launches, "max_abs_err": max_err,
             **main,
             "shape": {"nq": MAX_BATCH, "m": m, "d_in": d_in,
                       "d_out": d_out, "k_top": K_TOP},
             "at_nq1": rows[1]}
    print(json.dumps({"kernels": [entry]}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_parity()
    index, queries, serving, err = phase_serving()
    phase_kernels(index, queries, serving["launches"], err)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
