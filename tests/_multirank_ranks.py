"""The rank side of tests/test_torch_multirank.py: what each gloo rank runs
under ``repro_torch.launch.mesh.spawn``.

Kept apart from the test file, which imports jax: a spawned rank imports
the module its function lives in, and the ranks import torch, numpy and
``repro_torch`` only (``run_all`` reports any jax or ``repro`` module
found loaded). Every function here returns host values for the test
process to hold against the reference.
"""

import functools
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.core import dml, losses
from repro_torch.core.ps import sync, trainer
from repro_torch.data import loader, pairs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import ExactIndex, IVFIndex, RetrievalEngine, ivf, scan
from repro_torch.sharding import partition

N_RANKS = 4
FEAT, PROJ, BATCH, LR, STEPS = 24, 12, 64, 5e-2, 20
MODES = {"bsp": dict(sync="bsp"), "local": dict(sync="local", tau=2),
         "ssp": dict(sync="ssp", staleness=2)}
CHUNK_TAU = 2
COPY_STEPS = 4
KS = (1, 10, 200)            # 200 > the 150 rows a shard of 4 holds
NPROBES = (1, 3, 8)
IVF_KW = dict(n_clusters=8, nprobe=3, iters=6, seed=4)


def dataset():
    """test_torch_train.py's pair set: 400 rows at d 24, 4 classes."""
    cfg = pairs.PairDatasetConfig(n_samples=400, feat_dim=FEAT, n_classes=4,
                                  noise=1.0, seed=0)
    return pairs.train_eval_split(cfg, 1500, 1500, 400, 400)[0]


def ps_config(mode: str) -> trainer.DMLTrainConfig:
    return trainer.DMLTrainConfig(
        dml=dml.DMLConfig(feat_dim=FEAT, proj_dim=PROJ),
        ps=sync.PSConfig(n_workers=N_RANKS, **MODES[mode]),
        batch_size=BATCH, steps=STEPS, lr=LR, log_every=1)


def loss_fn(L, batch):
    return losses.dml_pair_loss(L, batch)


def _facts(mesh):
    """Coordinates, groups and the four collectives on this rank."""
    r = mesh.rank
    x = torch.tensor([float(r + 1)])
    out = {"shape": mesh.shape, "coords": dict(mesh.coords)}
    for axes in ("data", "model", ("data", "model"), ("model", "data")):
        onehot = torch.zeros(mesh.size)
        onehot[r] = 1.0
        out["+".join(axes) if isinstance(axes, tuple) else axes] = {
            "index": partition.axis_index(axes, mesh),
            "members": partition.psum(onehot, axes, mesh).nonzero()
            .flatten().tolist(),
            "psum": float(partition.psum(x, axes, mesh)),
            "pmean": float(partition.pmean(x, axes, mesh)),
            "gather": partition.all_gather(x, axes, mesh).flatten().tolist(),
            "gather_ids": partition.all_gather(
                torch.tensor([r, -1], dtype=torch.int32), axes, mesh)
            .tolist(),
        }
    out["tree"] = partition.psum(
        {"a": torch.tensor(2.0), "b": [torch.ones(3), None]}, "data", mesh)
    out["big"] = partition.all_gather(torch.tensor([1e30, -0.5]), "data",
                                      mesh)
    return out


def _placement(mesh):
    """block / constrain / shard_map / shard_batch on one global tensor."""
    g = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    batch = {"xs": g.numpy(), "sim": np.arange(4 * 6).reshape(4, 6)}
    summed = partition.shard_map(
        lambda a, b: (a * 2.0, b.sum()), mesh,
        in_specs=(("data", "model"), None),
        out_specs=(("data", "model"), ()))(g, g)
    return {
        "constrain": partition.constrain(g, ("batch", "ffn", None), mesh),
        "shard_map": summed,
        "shard_batch": loader.shard_batch(batch, ("data",), mesh),
    }


def _ps(inp, mesh):
    """train_dml_distributed over the worker mesh per mode, each rank's
    copy after every one of a few steps, and one chunk call."""
    train = dataset()
    L0, delays = inp["L0"], inp["delays"]
    out = {}
    for mode in MODES:
        L, hist = trainer.train_dml_distributed(
            ps_config(mode), train, L0=L0, delays=lambda t: delays[t],
            mesh=mesh)
        out[mode] = {"L": L, "loss": [h["loss"] for h in hist]}
    for mode in MODES:
        ps = ps_config(mode).ps
        state = sync.shard_state(sync.init_state(
            optim.sgd(LR), torch.from_numpy(L0), ps), ps, mesh)
        step = sync.make_train_step(loss_fn, optim.sgd(LR), ps,
                                    delays=lambda t: delays[t], mesh=mesh)
        stream = trainer.make_worker_streams(
            train, N_RANKS, BATCH, seed=0, device="cpu")[mesh.rank]
        copies = []
        for _ in range(COPY_STEPS):
            state, _ = step(state, {k: v[None]
                                    for k, v in next(stream).items()})
            copies.append(state.params[0].clone())
        out[f"{mode}_copies"] = torch.stack(copies)
        out[f"{mode}_merged"] = sync.worker_mean(state.params, mesh)
    ps = sync.PSConfig(n_workers=N_RANKS, sync="local", tau=CHUNK_TAU)
    state = sync.shard_state(sync.init_state(
        optim.sgd(LR), torch.from_numpy(L0), ps), ps, mesh)
    stream = trainer.make_worker_streams(train, N_RANKS, BATCH, seed=0,
                                         device="cpu")[mesh.rank]
    steps = [next(stream) for _ in range(CHUNK_TAU)]
    chunk = {k: torch.stack([b[k] for b in steps])[None] for k in steps[0]}
    state, m = sync.make_train_chunk(loss_fn, optim.sgd(LR), ps,
                                     mesh=mesh)(state, chunk)
    out["chunk"] = {"L": state.params[0], "loss": float(m["loss"]),
                    "step": state.step}
    return out


def _exact(inp, mesh4, mesh22):
    L, gp, gn, q, G = (inp[k] for k in ("L", "gp", "gn", "q", "G"))
    out = {}
    for name, mesh in (("4x1", mesh4), ("2x2", mesh22)):
        idx = ExactIndex.from_projected(L, gp, gn, mesh=mesh)
        out[name] = {"n_shards": idx.n_shards, "rows": idx.gp.shape[0],
                     "size": idx.size,
                     "answers": {k: idx.topk(q, k) for k in KS}}
    idx = ExactIndex.build(L, G, mesh=mesh4)
    out["build"] = {"n_shards": idx.n_shards, "answers": idx.topk(q, 10)}
    idx = ExactIndex.from_projected(L, gp[:-2], gn[:-2], mesh=mesh4)
    out["ragged"] = {"n_shards": idx.n_shards, "rows": idx.gp.shape[0],
                     "answers": idx.topk(q, 10)}
    return out


def _ivf(inp, mesh4, mesh22):
    L, gp, gn, q = (inp[k] for k in ("ivf_L", "ivf_gp", "ivf_gn", "ivf_q"))
    build = ivf.kmeans_projected
    ivf.kmeans_projected = functools.partial(build, start=inp["ivf_start"])
    try:
        out = {}
        for name, mesh in (("4x1", mesh4), ("2x2", mesh22)):
            idx = IVFIndex.build_projected(L, gp, gn, mesh=mesh, **IVF_KW)
            out[name] = {"n_shards": idx.n_shards, "cap": idx.cap,
                         "n_clusters": idx.n_clusters,
                         "pad_rows": len(idx.gn_pad),
                         "answers": {n: idx.topk(q, 7, nprobe=n)
                                     for n in NPROBES}}
        # a bad argument raises on every rank, before any collective
        out["refused"] = []
        for bad in (dict(gp=gp, n_clusters=len(gp) + 4),
                    dict(gp=gp[:, :-1], n_clusters=8)):
            try:
                IVFIndex.build_projected(L, bad["gp"], gn, mesh=mesh4,
                                         **dict(IVF_KW, **{
                                             "n_clusters": bad["n_clusters"]}))
            except ValueError as e:
                out["refused"].append(str(e))
        return out
    finally:
        ivf.kmeans_projected = build


def _served(inp, mesh4):
    """An engine on rank 0 over each sharded index, the others follow."""
    out = {}
    for name, idx in (
            ("exact", ExactIndex.from_projected(inp["L"], inp["gp"],
                                                inp["gn"], mesh=mesh4)),
            ("ivf", IVFIndex.build_projected(
                inp["ivf_L"], inp["ivf_gp"], inp["ivf_gn"], mesh=mesh4,
                **dict(IVF_KW, nprobe=8)))):
        q = inp["q"] if name == "exact" else inp["ivf_q"]
        if mesh4.rank != 0:
            out[name] = {"followed": scan.follow(idx)}
            continue
        with scan.lead(idx) as served:
            eng = RetrievalEngine(served, k_top=7, buckets=(8, 32),
                                  cache_size=0)
            eng.warmup()
            d, i = eng.search(q)
            d1, i1 = eng.search(q[0])
        out[name] = {"answers": (d, i), "single": (d1, i1),
                     "n_shards": eng.stats()["n_shards"]}
    return out


def run_all(inp):
    """Every case of the test file on this rank, in one group of 4."""
    mesh4 = mesh_lib.make_local_mesh()
    mesh22 = mesh_lib.make_local_mesh(model=2)
    worker_mesh = sync.make_worker_mesh(N_RANKS)
    out = {"rank": mesh4.rank, "backend": mesh4.backend,
           "device": str(mesh4.device),
           "facts_4x1": _facts(mesh4), "facts_2x2": _facts(mesh22),
           "placement": _placement(mesh22), "ps": _ps(inp, worker_mesh),
           "exact": _exact(inp, mesh4, mesh22),
           "ivf": _ivf(inp, mesh4, mesh22), "served": _served(inp, mesh4)}
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def fail_on(rank: int):
    """Rank ``rank`` raises; the others wait for it in a barrier."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def stall():
    """Rank 0 all-reduces; rank 1 never joins it."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(600)


def fail_while_leading(inp):
    """Rank 0 leads a sharded exact index and its call fails once
    announced: rank 0 returns whether the group was ended, the follower
    is left in the call's collective."""
    mesh = mesh_lib.make_local_mesh()
    idx = ExactIndex.from_projected(inp["L"], inp["gp"], inp["gn"],
                                    mesh=mesh)
    if mesh.rank != 0:
        return scan.follow(idx)

    def fail(q, k_top):
        raise ValueError("rank 0's scan fails on purpose")

    idx._scan = fail
    with scan.lead(idx) as served:
        try:
            served.topk(inp["q"], 3)
        except ValueError:
            pass
    return not dist.is_initialized()


def card_exact(inp):
    """A sharded exact index on the shared card: its answers and this
    rank's metric_topk launches."""
    from repro_torch.kernels.metric_topk import metric_topk_fused
    mesh = mesh_lib.make_local_mesh()
    idx = ExactIndex.from_projected(inp["L"], inp["gp"], inp["gn"],
                                    mesh=mesh)
    q = torch.from_numpy(inp["q"]).to(mesh.device)
    metric_topk_fused.launches = 0
    out = {k: idx.topk(q, k) for k in inp["ks"]}
    torch.cuda.synchronize()
    return {"answers": out, "launches": metric_topk_fused.launches,
            "n_shards": idx.n_shards, "device": str(mesh.device),
            "backend": mesh.backend}


def card_bsp(inp):
    """bsp steps over a worker mesh on the shared card; every copy
    gathered and compared on every rank."""
    from repro_torch.kernels.dml_pair import dml_pair_fused
    mesh = sync.make_worker_mesh(dist.get_world_size())
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    d, k, B = inp["d"], inp["k"], inp["B"]
    ps = sync.PSConfig(n_workers=mesh.size, sync="bsp")
    L0 = torch.from_numpy(inp["L0"]).to(dev)
    state = sync.shard_state(sync.init_state(optim.sgd(LR), L0, ps), ps,
                             mesh)
    step = sync.make_train_step(loss_fn, optim.sgd(LR), ps, mesh=mesh)
    dml_pair_fused.launches = 0
    for _ in range(inp["steps"]):
        batch = {"xs": torch.randn((1, B, d), generator=gen, device=dev),
                 "ys": torch.randn((1, B, d), generator=gen, device=dev),
                 "sim": (torch.rand((1, B), generator=gen, device=dev)
                         < 0.5).to(torch.int32)}
        state, _ = step(state, batch)
    copies = partition.all_gather(state.params[0], "workers", mesh)
    torch.cuda.synchronize()
    return {"equal": all(torch.equal(copies[0], c) for c in copies[1:]),
            "moved": float((state.params[0] - L0).abs().max()),
            "launches": dml_pair_fused.launches}
