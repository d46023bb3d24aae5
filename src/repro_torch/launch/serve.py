"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--batch 4] [--prompt-len 16] [--gen-len 32] [--reduced] [--device cpu]``.

Counterpart of ``repro.launch.serve``: prefill is a teacher-forced decode
over the prompt (state-carrying for the ssm and hybrid families,
cache-filling for attention), then a greedy decode loop with the arch's
cache (KV ring, for the dense and moe families / rwkv6's wkv state and
token shifts (``RWKVCache``) / Mamba2's SSM state and conv history beside
the shared block's KV ring). The moe family routes the batch's B tokens
a step under their own capacity.
Weights come from the port's seeded init. Runs on the card unless
``--device cpu`` is given; ``--reduced`` runs the smoke-scale variant in
f32. Prints prefill ms, ms a token, tokens/s and the generated shape.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.models import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen_len: int,
             keep_logits: bool = False) -> dict:
    """Teacher-forced prefill over ``prompts`` (B, P) through
    ``decode_step``, then greedy decode until ``P + gen_len`` positions.
    Returns the generated tokens (B, gen_len), the last logits, the
    prefill and decode seconds (host clock, synchronised), and with
    ``keep_logits`` the logits of every step (B, P + gen_len - 1, V)."""
    B, P = prompts.shape
    max_seq = P + gen_len
    dev = model.device
    with torch.inference_mode():
        cache = model.init_decode_cache(B, max_seq)
        _sync(dev)
        steps = []
        t0 = time.perf_counter()
        for t in range(P):
            logits, cache = model.decode_step(cache, prompts[:, t], t)
            if keep_logits:
                steps.append(logits)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        toks = torch.argmax(logits, dim=-1)
        out = [toks]
        t0 = time.perf_counter()
        for t in range(P, max_seq - 1):
            logits, cache = model.decode_step(cache, toks, t)
            if keep_logits:
                steps.append(logits)
            toks = torch.argmax(logits, dim=-1)
            out.append(toks)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    res = {"tokens": torch.stack(out, dim=1), "logits": logits,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_steps": len(out) - 1}
    if keep_logits:
        res["step_logits"] = torch.stack(steps, dim=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs there)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg).replace(dtype="float32")
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only — nothing to decode")
    device = resolve_device(args.device)
    model = Model(cfg, device=device, seed=0)

    rng = np.random.RandomState(0)
    prompts = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    out = generate(model, prompts, args.gen_len)
    per_token = out["decode_s"] / max(out["decode_steps"], 1)
    print(f"arch={cfg.name} batch={args.batch} device={device} "
          f"prefill={out['prefill_s'] * 1e3:.0f}ms "
          f"decode={per_token * 1e3:.1f} ms/token "
          f"({args.batch / per_token:.1f} tokens/s)")
    gen = out["tokens"].cpu().numpy()
    print(f"generated shape: {gen.shape}; sample: {gen[0, :12]}")
    assert bool(torch.isfinite(out["logits"]).all())
    return out


if __name__ == "__main__":
    main()
