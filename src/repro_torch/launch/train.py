"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps 50] [--batch 4] [--seq 128] [--lr 3e-4] [--reduced] [--remat]
[--ckpt DIR] [--log-every 10] [--device cpu]``.

Counterpart of ``repro.launch.train`` on one device: the seeded model ->
``token_stream`` batches (for ``input_kind="embeddings"`` configs,
pixtral-12b and hubert-xlarge, the reference's frame / patch embedding
batches with per-token labels: ``embedding_batches``) ->
``steps.make_train_step`` (the plain
training forward, chunked CE loss, AdamW on a cosine schedule with
warmup ``min(20, steps // 5)``) -> a checkpoint of the final params in
the reference's layout and format (``--ckpt``). Runs on the card unless
``--device cpu`` is given; ``--reduced`` trains the smoke-scale variant
in f32. ``--production-mesh`` builds the reference's pod mesh over the
process group, (data 16, model 16) on 256 ranks, or with ``--multi-pod``
(pod 2, data 16, model 16) on 512 (``--multi-pod`` alone asks for the
latter), prints it, and trains with ``mesh=None`` as the reference
does: every rank trains the whole model, and rank 0 writes the
checkpoint. Under ``torchrun`` the launcher joins the group
(``launch/mesh.join``); a group of another size, or none, raises, as
``jax.make_mesh`` does on fewer devices (``production_mesh``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import RunConfig, get_config, reduced as reduce_cfg
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (LiveMesh, Mesh, join,
                                     make_production_mesh)
from repro_torch.models import Model
from repro_torch.models.transformer import stack_blocks


def embedding_batches(cfg: ArchConfig, batch_size: int, seq_len: int,
                      device=None) -> Iterator[dict]:
    """The reference launcher's batches for ``input_kind="embeddings"``,
    forever: {embeddings (B, T, d_model) f32 ~ N(0, 1), labels (B, T)
    int32 uniform over the vocabulary}, drawn from
    ``RandomState(0)`` in the reference's order (bit-equal), then moved
    to ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    while True:
        emb = rng.randn(batch_size, seq_len, cfg.d_model).astype(np.float32)
        labels = rng.randint(0, cfg.vocab_size,
                             (batch_size, seq_len)).astype(np.int32)
        yield {"embeddings": torch.from_numpy(emb).to(dev),
               "labels": torch.from_numpy(labels).to(dev)}


def train_loop(train_step, state, batches, n_steps: int,
               log_every: int = 10, log=print):
    """Run ``n_steps`` of ``train_step`` over ``batches`` (an iterator).
    Returns (state, per-step losses, grad norms and moe aux losses (0
    outside the moe family) as floats, the seconds of each step on the
    host clock, synchronised)."""
    dev = state.step.device
    losses, gnorms, auxs, secs = [], [], [], []
    t_start = time.perf_counter()
    for t in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, next(batches))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        auxs.append(float(metrics["moe_aux"]))
        if log is not None and (t % log_every == 0 or t == n_steps - 1):
            log(f"step {t:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
                f"({(time.perf_counter() - t_start) / (t + 1) * 1e3:.0f} "
                f"ms/step)")
    return state, {"loss": losses, "grad_norm": gnorms, "moe_aux": auxs,
                   "step_s": secs}


def build(arch: str, steps: int, lr: float = 3e-4, reduced: bool = False,
          remat: bool = False, device=None, cfg=None):
    """(model, train step, initial state) as the launcher makes them;
    ``cfg`` replaces the registry's config."""
    if cfg is None:
        cfg = get_config(arch)
        if reduced:
            cfg = reduce_cfg(cfg).replace(dtype="float32")
    run = RunConfig(arch=arch, lr=lr, total_steps=steps,
                    warmup=min(20, steps // 5), remat=remat)
    model = Model(cfg, device=resolve_device(device), seed=run.seed)
    opt = steps_lib.make_optimizer(run)
    state = steps_lib.init_train_state(model, opt)
    train_step = steps_lib.make_train_step(model, opt, run, loss_chunks=2)
    return model, train_step, state


def production_mesh(world_size: int, multi_pod: bool = False) -> Mesh:
    """The pod mesh's shape for a group of ``world_size`` ranks: (data
    16, model 16) at 256, (pod 2, data 16, model 16) at 512 under
    ``multi_pod``; any other size raises."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    if world_size != mesh.size:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'production'} mesh "
            f"{mesh.shape} needs a group of {mesh.size} ranks, and this "
            f"one has {world_size} (start the ranks with torchrun)")
    return mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (f32)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="build the (data=16, model=16) pod mesh over a "
                         "group of 256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="build the (pod=2, data=16, model=16) mesh over "
                         "a group of 512 ranks")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs there)")
    args = ap.parse_args(argv)
    mesh = None
    if args.production_mesh or args.multi_pod:
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            join(args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        shape = production_mesh(world, args.multi_pod)
        mesh = LiveMesh(shape.axis_names, shape.axis_sizes)

    device = resolve_device(args.device) if mesh is None else mesh.device
    model, train_step, state = build(
        args.arch, args.steps, lr=args.lr, reduced=args.reduced,
        remat=args.remat, device=device)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device}"
          + (f" mesh={mesh.shape}" if mesh is not None else ""))
    if cfg.input_kind == "embeddings":
        stream = embedding_batches(cfg, args.batch, args.seq, device=device)
    else:
        stream = token_stream(cfg.vocab_size, args.batch, args.seq,
                              device=device)
    state, hist = train_loop(train_step, state, stream, args.steps,
                             args.log_every)
    print(f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}")
    if args.ckpt and (mesh is None or mesh.rank == 0):
        path = save_checkpoint(args.ckpt, args.steps,
                               {"params": stack_blocks(state.params)})
        print(f"checkpoint: {path}")
    return state, hist


if __name__ == "__main__":
    main()
