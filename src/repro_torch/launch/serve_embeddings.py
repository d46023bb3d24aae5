"""Embedding service: token batches -> backbone embeddings -> metric
retrieval under a learned Mahalanobis factor.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_embeddings \
          [--arch zamba2-2.7b] [--reduced] [--seq-len 32] [--corpus 64] \
          [--batch 8] [--requests 3] [--proj-dim 64] [--k 5] [--device cpu]

Counterpart of ``examples/serve_embeddings.py``: a corpus of token
sequences is embedded once (``Model.embed_pool``: the mean-pooled final
hidden state), then each request batch is embedded and ranked against
the corpus under L (``metric_sqdist_matrix``: the projection, then the
``pairwise_sqdist`` kernel), top-k in the (distance, id) order of
``kernels/_dispatch.topk_by_distance``. Weights come from the port's
seeded init (no checkpoint), L from ``core.dml.init_params``, token ids
from a seeded ``numpy.random.RandomState``. It takes every family; the
vlm and audio configs (``--arch pixtral-12b``, ``hubert-xlarge``) embed
token batches here too, as the reference's ``embed_pool`` allows. From
Python, ``embed`` and ``serve`` also take ``Model.embed_pool`` batch
dicts, such as those families' ``{"embeddings": (B, T, d_model)}`` frame
/ patch batches. On the card the backbone runs Mamba2's SSD core
on the ``ssd_scan`` kernel and attention on the ``flash_attention``
kernel; the moe family (``--arch granite-moe-1b-a400m``,
``qwen3-moe-30b-a3b``) runs its expert layer in plain torch beside it;
rwkv6 (``--arch rwkv6-1.6b``) has no kernel of its own and runs its
chunked form in plain torch. Runs on the card unless ``--device cpu`` is
given. Prints requests/s, tokens/s and p50 /
p99 ms per request batch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import dml
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import topk_by_distance
from repro_torch.kernels.pairwise_dist import metric_sqdist_matrix
from repro_torch.models import Model
from repro_torch.obs import percentile


def build(arch: str = "zamba2-2.7b", reduced: bool = False, device=None,
          proj_dim: int = 64, seed: int = 0):
    """(model, L): the backbone from the seeded init and a seeded
    (proj_dim, d_model) metric factor, both on ``device``."""
    cfg = get_config(arch + ("-reduced" if reduced else ""))
    dev = resolve_device(device)
    model = Model(cfg, device=dev, seed=seed)
    L = dml.init_params(dml.DMLConfig(feat_dim=cfg.d_model,
                                      proj_dim=proj_dim),
                        torch.Generator(device=dev).manual_seed(seed + 7),
                        dev)
    return model, L


def token_batches(vocab: int, n_rows: int, seq_len: int, batch: int,
                  rng: np.random.RandomState):
    """``n_rows`` random sequences in (batch, seq_len) int64 arrays."""
    toks = rng.randint(0, vocab, (n_rows, seq_len)).astype(np.int64)
    return [toks[i:i + batch] for i in range(0, n_rows, batch)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def embed(model: Model, batch) -> torch.Tensor:
    """(B, d_model) f32 embeddings of a (B, T) token array, or of a
    ``Model.embed_pool`` batch dict."""
    if not isinstance(batch, dict):
        batch = {"tokens": torch.from_numpy(batch)}
    with torch.inference_mode():
        return model.embed_pool(batch)


def _rows_and_len(batch) -> tuple[int, int]:
    """(B, T) of a token array or a batch dict."""
    x = next(iter(batch.values())) if isinstance(batch, dict) else batch
    return x.shape[0], x.shape[1]


def rank(L: torch.Tensor, req_emb: torch.Tensor, corpus_emb: torch.Tensor,
         k: int):
    """(distances, corpus ids) of each request's k nearest corpus rows
    under L, ascending (distance, id)."""
    D = metric_sqdist_matrix(L, req_emb, corpus_emb)
    ids = torch.arange(corpus_emb.shape[0], dtype=torch.int32,
                       device=D.device).expand(D.shape[0], -1)
    return topk_by_distance(D, ids, k)


def serve(model: Model, L: torch.Tensor, corpus_batches, request_batches,
          k: int) -> dict:
    """Embed the corpus batch by batch, then answer each request batch
    (each batch as ``embed`` takes it); host clock, every batch ends in a
    synchronize. Returns the corpus embeddings, the answers and the
    timings."""
    dev = model.device
    n_corpus = sum(_rows_and_len(b)[0] for b in corpus_batches)
    if not 1 <= k <= n_corpus:
        raise ValueError(f"k={k} must be in [1, {n_corpus}]")
    _sync(dev)
    t0 = time.perf_counter()
    corpus_emb = torch.cat([embed(model, b) for b in corpus_batches])
    _sync(dev)
    corpus_s = time.perf_counter() - t0
    lat, embs, dists, ids = [], [], [], []
    t0 = time.perf_counter()
    for toks in request_batches:
        t1 = time.perf_counter()
        embs.append(embed(model, toks))
        d, i = rank(L, embs[-1], corpus_emb, k)
        dists.append(d.cpu())
        ids.append(i.cpu())
        lat.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    dims = [_rows_and_len(b) for b in request_batches]
    n_req = sum(B for B, _ in dims)
    n_tok = sum(B * T for B, T in dims)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50, p99 = percentile(lat_ms, (50.0, 99.0))
    return {"corpus_emb": corpus_emb, "request_emb": torch.cat(embs),
            "corpus_s": corpus_s,
            "dists": torch.cat(dists), "ids": torch.cat(ids),
            "batch_ms": [1e3 * x for x in lat], "wall_s": wall,
            "requests_per_s": n_req / wall, "tokens_per_s": n_tok / wall,
            "p50_ms": p50, "p99_ms": p99}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b",
                    help="a dense (smollm-135m), moe (granite-moe-1b-a400m,"
                         " qwen3-moe-30b-a3b), ssm (rwkv6-1.6b), hybrid "
                         "(zamba2-2.7b), vlm (pixtral-12b) or audio "
                         "(hubert-xlarge) config of repro_torch.configs")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test reduction of --arch")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--corpus", type=int, default=64,
                    help="corpus sequences, embedded once")
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences per corpus and request batch")
    ap.add_argument("--requests", type=int, default=3,
                    help="request batches served")
    ap.add_argument("--proj-dim", type=int, default=64,
                    help="rows (d_out) of the metric factor L")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    model, L = build(args.arch, args.reduced, args.device, args.proj_dim,
                     args.seed)
    cfg = model.cfg
    rng = np.random.RandomState(args.seed)
    corpus = token_batches(cfg.vocab_size, args.corpus, args.seq_len,
                           args.batch, rng)
    requests = token_batches(cfg.vocab_size, args.requests * args.batch,
                             args.seq_len, args.batch, rng)
    out = serve(model, L, corpus, requests, args.k)
    print(f"{cfg.name}: corpus {tuple(out['corpus_emb'].shape)} embedded "
          f"in {out['corpus_s']:.2f}s on {model.device} "
          f"({args.seq_len} tokens a sequence)")
    for b, ms in enumerate(out["batch_ms"]):
        top1 = out["ids"][b * args.batch:(b + 1) * args.batch, 0].tolist()
        print(f"batch {b}: {len(requests[b])} requests in {ms:.1f} ms; "
              f"top-1 ids {top1}")
    print(f"requests/s {out['requests_per_s']:.2f}, tokens/s "
          f"{out['tokens_per_s']:.0f}, batch ms p50 {out['p50_ms']:.1f} "
          f"p99 {out['p99_ms']:.1f}")
    if not bool(torch.isfinite(out["dists"]).all()):
        raise RuntimeError("non-finite distances")
    return out


if __name__ == "__main__":
    main()
