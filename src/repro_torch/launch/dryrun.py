"""Dry-run account: the work of one step of every (arch x input shape)
on one H100, counted over ``meta`` tensors (counterpart of
``repro/launch/dryrun.py``).

For each combination this module:
  1. builds the model on ``meta`` (shapes, no storage) and the step
     function (train / prefill / decode per shape);
  2. runs the step's plain path (the reference's own forms: naive or
     chunked attention, chunked SSD, chunked rwkv6) on the meta inputs of
     ``steps.input_specs`` / ``steps.cache_shape_structs`` under
     ``cost_analysis.CostMode``: nothing is allocated and nothing
     launches, the counterpart of the reference lowering on host devices;
  3. records FLOPs by dtype, HBM bytes, argument / output / peak temp
     bytes, ops and the roofline terms at the H100's rates
     (``launch/mesh.py``);
  4. appends the record to ``build/dryrun/dryrun_h100.json``.

On a production mesh (``--mesh 16x16``; ``--multi-pod``, which is
``--mesh pod2x16x16``) the record is one rank's program: the step's
per-rank map (``launch/steps.py``, ``Model.rank_map`` /
``rank_decode_map``; the DML step ``core/losses``'
``dml_pair_value_and_grad_rank``) traced on that rank's blocks as meta
tensors inside ``launch/mesh.fake_world`` (a world of 256 or 512 ranks
over torch's fake backend, entered as rank 0, which holds the largest
block where a dimension does not divide), under the same ``CostMode``:
FLOPs, HBM bytes, memory, and the collectives it issues by the
reference's kinds, with the roofline's ``collective_s`` at each group's
link (``launch/mesh.link``). Its ``argument_size`` must equal the
sharding plan's (``plan_arguments``: parameter, AdamW-state and input or
cache shards). Every family has it (the moe layers' expert map nested
in the program, the frame / patch projection on a rank's rows, hubert's
non-causal attention and biases, rwkv6's and zamba2's mixers on the
rank's heads, their decode caches moved between the plan's stacked
layout and the rank's working one), and so do the paper's DML
configs.

The counts follow ``cost_analysis``'s rules; two matter when a record is
read against the card. The plain attention computes the full T x S
product of every (q, kv) tile and masks it, so a causal or windowed
step counts about twice the FLOPs the card's flash kernel does (its
masked tiles are skipped); the prefill and training records count the
plain path throughout. Decode runs one token at position ``seq_len - 1``
against a full cache.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-done] [--jobs 8]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --dml
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import time
import traceback
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, get_shape, list_configs
from repro_torch.configs.base import ArchConfig, InputShape, RunConfig
from repro_torch.launch import cost_analysis, mesh as mesh_lib, steps
from repro_torch.models.transformer import Model, stack_cache
from repro_torch.sharding import partition
from repro_torch.sharding.partition import local_shape, logical_to_physical

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "build", "dryrun")


def _artifact_path(mesh_name: str) -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    return os.path.join(ARTIFACT_DIR, f"dryrun_{mesh_name}.json")


def _load(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _store(path, records):
    with open(path, "w") as f:
        json.dump(records, f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# Model FLOPs (benchmarks/roofline.py's conventions)
# ---------------------------------------------------------------------------

def _attn_params(cfg: ArchConfig) -> int:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dim_per_head
    return d * H * dh + 2 * d * K * dh + H * dh * d


def _mlp_params(cfg: ArchConfig, f=None) -> int:
    f = f or cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return 3 * cfg.d_model * f
    if cfg.mlp_kind == "gelu":
        return 2 * cfg.d_model * f
    if cfg.mlp_kind == "rwkv_channel_mix":
        return 2 * cfg.d_model * f + cfg.d_model * cfg.d_model
    return 3 * cfg.d_model * f


def param_counts(cfg: ArchConfig):
    """(total_params, active_params) excluding embeddings (standard 6ND)."""
    d = cfg.d_model
    L = cfg.n_layers
    if cfg.family == "ssm":       # rwkv6
        tmix = 5 * d * d + 2 * d * max(32, d // 32)
        per_layer = tmix + _mlp_params(cfg)
        return L * per_layer, L * per_layer
    if cfg.family == "hybrid":    # zamba2: mamba2 stack + ONE shared block
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        mamba = (d * d_in + d * (d_in + 2 * n) + d * cfg.ssm_heads
                 + d_in * d)
        shared = _attn_params(cfg) + 2 * d * cfg.d_ff
        total = L * mamba + shared
        # the shared block RUNS L/every times: active compute counts each use
        active = L * mamba + (L // cfg.shared_attn_every) * shared
        return total, active
    per_layer = _attn_params(cfg)
    if cfg.n_experts:
        experts = cfg.n_experts * 3 * d * cfg.d_ff + d * cfg.n_experts
        active = (_attn_params(cfg) + cfg.top_k * 3 * d * cfg.d_ff
                  + d * cfg.n_experts)
        return L * (per_layer + experts), L * active
    per_layer += _mlp_params(cfg)
    return L * per_layer, L * per_layer


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """6ND (train), 2ND (prefill), 2NB (decode: one token a sequence),
    N the active parameters without embeddings."""
    _, active = param_counts(cfg)
    B, T = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return 6.0 * active * B * T
    if shape.mode == "prefill":
        return 2.0 * active * B * T
    return 2.0 * active * B


# ---------------------------------------------------------------------------
# The account of one step on one card
# ---------------------------------------------------------------------------

def account(step, *args) -> dict:
    """Run ``step(*args)`` (meta tensors) under ``CostMode``: FLOPs by
    dtype, HBM bytes, ops, the memory record, the collectives and the
    roofline terms at the H100's rates (each dtype's FLOPs at its rate,
    ``mesh.PEAK_FLOPS_BY_DTYPE``; each collective's bytes at its link's,
    ``cost_analysis.collective_seconds``). ``memory.temp_size`` is the
    peak of the bytes the step allocated and still held (its outputs
    among them while they are live); ``peak_bytes`` adds the
    arguments."""
    mode = cost_analysis.CostMode()
    argument = mode.add_arguments(args)
    t0 = time.perf_counter()
    with mode:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    counts = mode.summary()
    output = mode.new_bytes(out)
    del out
    rates = mesh_lib.PEAK_FLOPS_BY_DTYPE
    compute_s = cost_analysis.compute_seconds(counts["flops_by_dtype"],
                                              rates)
    flops = counts["flops"]
    # one rate for roofline_terms: the FLOPs over the dtype-weighted time,
    # and the collective bytes over their links' time
    peak_flops = flops / compute_s if compute_s else mesh_lib.PEAK_FLOPS_F32
    coll = counts["collectives"]
    coll_s = cost_analysis.collective_seconds(coll["by_link"])
    link = coll["total_bytes"] / coll_s if coll_s else mesh_lib.NVLINK_BW
    terms = cost_analysis.roofline_terms(
        flops, counts["hbm_bytes"], coll["total_bytes"], 1, peak_flops,
        mesh_lib.HBM_BW, link)
    peak = argument + counts["peak_bytes"]
    return {
        "trace_s": trace_s,
        "ops": counts["ops"],
        "memory": {"argument_size": argument, "output_size": output,
                   "temp_size": counts["peak_bytes"]},
        "peak_bytes": peak,
        "fits_80gb": peak <= mesh_lib.HBM_BYTES,
        "flops_per_chip": flops,
        "flops_by_dtype": counts["flops_by_dtype"],
        "hbm_bytes_per_chip": counts["hbm_bytes"],
        "peak_flops": peak_flops,
        "collectives": coll,
        "roofline": terms,
    }


def _build(arch: str, shape_name: str, overrides: Optional[dict]):
    shape = get_shape(shape_name)
    base_cfg = get_config(arch)
    skip = steps.skip_reason(base_cfg, shape)
    cfg = steps.effective_config(base_cfg, shape)
    if overrides:
        cfg = cfg.replace(**overrides)
    return shape, cfg, skip


def _head(arch, shape_name, mesh_name, overrides):
    """(shape, cfg, the record's head, or a "skipped" record)."""
    mesh = mesh_lib.MESHES[mesh_name]
    shape, cfg, skip = _build(arch, shape_name, overrides)
    head = {"arch": arch, "shape": shape_name, "mesh": mesh.shape}
    if skip:
        return shape, cfg, {"status": "skipped", "reason": skip, **head}
    head.update(mode=shape.mode, n_chips=mesh.size,
                attn_variant=cfg.attention)
    return shape, cfg, head


def plan_record(arch: str, shape_name: str, mesh: str,
                overrides: dict = None) -> dict:
    """The sharding plan's record of one combination on a production mesh
    (a name of ``mesh.MESHES``): its per-rank arguments
    (``plan_arguments``), status ``"plan"``, traced nothing."""
    shape, cfg, head = _head(arch, shape_name, mesh, overrides)
    if head.get("status") == "skipped":
        return head
    return {"status": "plan", **head,
            "memory": plan_arguments(cfg, shape, mesh_lib.MESHES[mesh])}


def dryrun_one(arch: str, shape_name: str, mesh: str = "h100",
               loss_chunks: int = 8, overrides: dict = None) -> dict:
    """The record of one combination on ``mesh``, a name of
    ``mesh.MESHES``: the account on one H100 (``"h100"``), or one rank's
    program on a production mesh (``"16x16"``, ``"pod2x16x16"``), its
    arguments held to the plan's (``plan_record``).

    ``overrides``: ArchConfig.replace(**overrides) knobs (chunk sizes,
    dtypes, ...)."""
    shape, cfg, head = _head(arch, shape_name, mesh, overrides)
    if head.get("status") == "skipped":
        return head
    if mesh != "h100":
        plan = plan_record(arch, shape_name, mesh, overrides)["memory"]
        with mesh_lib.fake_world(mesh) as live:
            acct = rank_account(cfg, shape, live, loss_chunks)
        if acct["memory"]["argument_size"] != plan["argument_size"]:
            raise AssertionError(f"{arch}|{shape_name} on {mesh}: the "
                                 f"rank's arguments {acct['memory']} are "
                                 f"not the plan's {plan}")
        return {"status": "ok", **head, "card": mesh_lib.CARD, "rank": 0,
                "plan": plan, "model_flops": model_flops(cfg, shape),
                **acct}
    model = Model(cfg, device="meta")
    run = RunConfig(arch=arch, shape=shape_name)
    specs = steps.input_specs(cfg, shape)
    if shape.mode == "train":
        opt = steps.make_optimizer(run)
        state = steps.init_train_state(model, opt)
        step = steps.make_train_step(model, opt, run,
                                     loss_chunks=loss_chunks)
        rec = account(step, state, specs)
    elif shape.mode == "prefill":
        rec = account(lambda params, b: model.apply(b, plain=True)[0],
                      model.param_tree(), specs)
    else:
        serve = steps.make_serve_step(model, run)
        batch = {"tokens": specs["tokens"], "pos": shape.seq_len - 1}
        rec = account(lambda params, cache, b: serve(cache, b),
                      model.param_tree(),
                      steps.cache_shape_structs(model, shape), batch)
    return {"status": "ok", **head, "card": mesh_lib.CARD,
            "model_flops": model_flops(cfg, shape), **rec}


def rank_map(cfg: ArchConfig, shape: InputShape, live,
             loss_chunks: int = 8):
    """(per-rank map, its global arguments as meta tensors) of the step
    of ``cfg`` x ``shape`` on the live mesh ``live``: what
    ``rank_account`` traces, and what ranks run for real."""
    model = Model(cfg, device="meta")
    run = RunConfig(arch=cfg.name, shape=shape.name)
    specs = steps.input_specs(cfg, shape)
    if shape.mode == "train":
        opt = steps.make_optimizer(run)
        state = steps.init_train_state(model, opt)
        return steps.rank_train_map(model, opt, run, live, specs,
                                    loss_chunks), (state, specs)
    if shape.mode == "prefill":
        return model.rank_map(live, specs, "logits", plain=False), \
            (model.param_tree(), specs)
    cache = steps.cache_shape_structs(model, shape)
    if model.recurrent:         # the reference's stacked layout
        cache = stack_cache(cache)
    return model.rank_decode_map(live, cache, specs["tokens"].shape,
                                 shape.seq_len - 1), \
        (model.param_tree(), cache, specs["tokens"])


def rank_account(cfg: ArchConfig, shape: InputShape, live,
                 loss_chunks: int = 8) -> dict:
    """The account of rank 0's program (``rank_map``) on its blocks of
    the arguments, meta tensors of ``partition.local_shape``; decode's
    position is an argument too, as in the reference (the port's program
    takes it as a Python int)."""
    rmap, args = rank_map(cfg, shape, live, loss_chunks)
    blocks = partition.local_blocks(args, rmap.in_specs, live)
    if shape.mode != "decode":
        return account(rmap.body, *blocks)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return account(lambda p, c, t, _pos: rmap.body(p, c, t), *blocks, pos)


# ---------------------------------------------------------------------------
# The plan's per-rank arguments on a production mesh
# ---------------------------------------------------------------------------

def _shard_bytes(tensors, specs, mesh) -> int:
    """Per-rank bytes of ``tensors`` (a flat list) placed by ``specs``."""
    total = 0
    for t, spec in zip(tensors, specs):
        n = 1
        for s in local_shape(tuple(t.shape), spec, mesh):
            n *= s
        total += n * t.element_size()
    return total


def _pairs(tree, specs, out):
    """(tensor, spec) leaf pairs of a tree and its spec tree (spec leaves
    are tuples; a NamedTuple is a container)."""
    if isinstance(tree, torch.Tensor):
        out.append((tree, specs))
    elif isinstance(tree, dict):
        for k in tree:
            _pairs(tree[k], specs[k], out)
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            _pairs(t, s, out)
    return out


def _bytes_of(tree, specs, mesh) -> int:
    pairs = _pairs(tree, specs, [])
    return _shard_bytes([t for t, _ in pairs], [s for _, s in pairs], mesh)


def plan_arguments(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Per-rank argument bytes of a step under the sharding plan: the
    parameters (prefill, decode) or the train state (parameters, AdamW
    moments, step), the inputs, and for decode the cache in the
    reference's stacked layout (``steps.cache_shardings``)."""
    model = Model(cfg, device="meta")
    run = RunConfig(arch=cfg.name, shape=shape.name)
    params = model.param_tree()
    pshard = steps.param_shardings(model, params, mesh)
    specs = steps.input_specs(cfg, shape)
    out = {"params": _bytes_of(params, pshard, mesh),
           "inputs": _bytes_of(specs, steps.input_shardings(specs, mesh),
                               mesh)}
    if shape.mode == "train":
        state = steps.init_train_state(model, steps.make_optimizer(run))
        sshard = steps.make_state_shardings(state, params, pshard, mesh)
        out["opt_state"] = _bytes_of(state.opt_state, sshard.opt_state,
                                     mesh)
        out["step"] = _bytes_of(state.step, sshard.step, mesh)
    elif shape.mode == "decode":
        cache = steps.cache_shape_structs(model, shape)
        cshard = steps.cache_shardings(model, cfg, shape, mesh)
        stacked = steps.stacked_cache_shapes(cache)
        out["cache"] = 0
        for key, layers in cache.items():
            for field, leaf in enumerate(layers[0]):
                t = torch.empty(stacked[key][field], dtype=leaf.dtype,
                                device="meta")
                out["cache"] += _shard_bytes([t], [cshard[key][field]],
                                             mesh)
    out["argument_size"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# The paper's DML configs
# ---------------------------------------------------------------------------

def _dml_step(dcfg, mesh=None, rows_split: bool = False):
    """The reference's step: the Eq. 4 loss's gradient, L - 0.01 g; on a
    live ``mesh`` one rank's (``losses.dml_pair_value_and_grad_rank``)."""
    from repro_torch.core import losses as losses_mod
    from repro_torch.tree import value_and_grad

    if mesh is not None:
        def rank_step(L, b):
            loss, g = losses_mod.dml_pair_value_and_grad_rank(
                L, b, mesh, rows_split=rows_split, lam=dcfg.lam,
                margin=dcfg.margin)
            return L - 0.01 * g, loss
        return rank_step

    def train_step(L, b):
        (loss, aux), g = value_and_grad(
            lambda p, bb: losses_mod.dml_pair_loss(
                p, bb, lam=dcfg.lam, margin=dcfg.margin), L, b)
        with torch.no_grad():
            return L - 0.01 * g, loss
    return train_step


def dml_specs(dcfg, B: int, mesh):
    """(L, batch) of a DML step as meta tensors, and their specs on
    ``mesh``: L's rows over ``model`` where they divide it, the pairs
    over the batch axes."""
    L = torch.empty((dcfg.proj_dim, dcfg.feat_dim), device="meta")
    batch = {"xs": torch.empty((B, dcfg.feat_dim), device="meta"),
             "ys": torch.empty((B, dcfg.feat_dim), device="meta"),
             "sim": torch.empty((B,), dtype=torch.int32, device="meta")}
    Lspec = logical_to_physical(("proj", "feat"), mesh, shape=tuple(L.shape))
    bspec = {k: logical_to_physical(("pairs",) + (None,) * (v.ndim - 1),
                                    mesh, shape=tuple(v.shape))
             for k, v in batch.items()}
    return (L, batch), (Lspec, bspec)


def dryrun_dml(mesh: str = "h100") -> dict:
    """The paper's own DML configs (a train step over a pair batch) on
    ``mesh`` (a name of ``mesh.MESHES``): the account on one H100, or
    rank 0's program on a production mesh, where the pairs a step are
    the paper's minibatch on each data rank and L's rows go over
    ``model`` where they divide it."""
    from repro_torch.configs import dml_paper

    name = mesh
    mesh = mesh_lib.MESHES[name]
    shp = mesh.shape
    out = {}
    for exp_name, exp in dml_paper.EXPERIMENTS.items():
        dcfg = exp.dml
        B = exp.batch_size * shp["data"] * shp.get("pod", 1)
        args, specs = dml_specs(dcfg, B, mesh)
        rec = {"arch": exp_name, "shape": "paper_batch", "mesh": shp,
               "n_chips": mesh.size, "global_pair_batch": B}
        if name == "h100":
            out[exp_name] = {"status": "ok", **rec, "card": mesh_lib.CARD,
                             **account(_dml_step(dcfg), *args)}
        else:
            plan = _shard_bytes([args[0]], [specs[0]], mesh) + \
                _bytes_of(args[1], specs[1], mesh)
            split = specs[0][0] is not None
            with mesh_lib.fake_world(name) as live:
                blocks = partition.local_blocks(args, specs, live)
                acct = account(_dml_step(dcfg, live, split), *blocks)
            if acct["memory"]["argument_size"] != plan:
                raise AssertionError(f"{exp_name} on {name}: the rank's "
                                     f"arguments are not the plan's {plan}")
            out[exp_name] = {"status": "ok", **rec, "card": mesh_lib.CARD,
                             "rank": 0, "rows_split": split,
                             "plan": {"argument_size": plan}, **acct}
        print(f"[dml dryrun] {exp_name}: {out[exp_name]['status']}",
              flush=True)
    return out


def summary_line(key: str, rec: dict) -> str:
    """One line of a record: FLOPs (by dtype), argument and temp GB, fit,
    the roofline terms and the trace's seconds."""
    if rec["status"] == "skipped":
        return f"[dryrun] {key}: SKIPPED ({rec['reason']})"
    if rec["status"] != "ok":
        return f"[dryrun] {key}: ERROR {rec['error']}"
    t, m = rec["roofline"], rec["memory"]
    by = ", ".join(f"{d} {f:.4g}" for d, f in
                   sorted(rec["flops_by_dtype"].items()))
    c = rec["collectives"]
    kinds = ", ".join(f"{k} {c['counts'][k]} x {b / 1e9:.3g} GB"
                      for k, b in sorted(c["bytes"].items()))
    return (f"[dryrun] {key}: {rec['flops_per_chip']:.4g} FLOP ({by}), "
            f"{rec['hbm_bytes_per_chip']:.4g} B, argument "
            f"{m['argument_size'] / 1e9:.2f} GB, temp "
            f"{m['temp_size'] / 1e9:.2f} GB, fits "
            f"{rec['fits_80gb']}, collectives [{kinds or 'none'}], compute "
            f"{t['compute_s'] * 1e3:.2f} ms, memory "
            f"{t['memory_s'] * 1e3:.2f} ms, collective "
            f"{t['collective_s'] * 1e3:.2f} ms, {t['dominant']}, "
            f"{rec['ops']} ops, traced in {rec['trace_s']:.1f} s")


class Job(NamedTuple):
    """One combination of a sweep."""
    arch: str
    shape: str
    overrides: Optional[dict] = None


def _record(job: Job, mesh: str) -> Tuple[str, dict]:
    """(key, record) of one job on ``mesh``; an exception becomes an
    "error" record."""
    try:
        rec = dryrun_one(job.arch, job.shape, mesh,
                         overrides=job.overrides)
    except Exception as e:
        rec = {"status": "error", "arch": job.arch, "shape": job.shape,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
    return f"{job.arch}|{job.shape}", rec


def sweep(jobs, mesh: str = "h100",
          procs: int = 1) -> Iterator[Tuple[str, dict]]:
    """(key, record) of each job on ``mesh`` as it finishes, traced in
    ``procs`` spawned processes (in this one if 1)."""
    one = functools.partial(_record, mesh=mesh)
    if procs > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(procs, len(jobs))) as pool:
            yield from pool.imap_unordered(one, jobs)
    else:
        yield from map(one, jobs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dml", action="store_true")
    ap.add_argument("--mesh", choices=sorted(mesh_lib.MESHES),
                    default="h100",
                    help="the account on one H100, or rank 0's program on "
                         "(data 16, model 16) or (pod 2, data 16, model 16)")
    ap.add_argument("--multi-pod", dest="mesh", action="store_const",
                    const="pod2x16x16", help="--mesh pod2x16x16")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, a process each")
    args = ap.parse_args(argv)

    path = _artifact_path(args.mesh)
    records = _load(path)

    if args.dml:
        for k, v in dryrun_dml(args.mesh).items():
            records[f"{k}|paper_batch"] = v
            print(summary_line(f"{k}|paper_batch", v), flush=True)
        _store(path, records)
        return

    if args.all:
        combos = [(arch, shape) for arch in list_configs()
                  for shape in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, --all or --dml")

    todo = []
    for arch, shape in combos:
        key = f"{arch}|{shape}"
        if args.skip_done and records.get(key, {}).get("status") in (
                "ok", "skipped"):
            print(f"[dryrun] {key}: cached, skipping", flush=True)
        else:
            todo.append(Job(arch, shape))
    for key, rec in sweep(todo, args.mesh, args.jobs):
        records[key] = rec
        _store(path, records)
        print(summary_line(key, rec), flush=True)


if __name__ == "__main__":
    main()
