"""The rank side of tests/test_torch_multirank_moe.py: what each gloo rank
runs under ``repro_torch.launch.mesh.spawn``.

Kept apart from the test file, which imports jax: a spawned rank imports
the module its function lives in, and the ranks import torch, numpy and
``repro_torch`` only (``run_all`` reports any jax or ``repro`` module
found loaded). Every function returns host values for the test process
to hold against the reference and the one-process oracle.
"""

import sys

import torch

from repro_torch import convert, optim
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.ps import sync
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.mining import ClosedLoopTrainer
from repro_torch.models import moe
from repro_torch.sharding import partition
from repro_torch.tree import value_and_grad

N_RANKS = 4
ARCH = "granite-moe-1b-a400m"
SHAPES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
DECODE_SHAPES = ("1x4", "2x2")
AUX_W = 3.0                 # the layer's loss: sum(y * cot) + AUX_W * aux
DECODE_STEPS = 4
LR = 1e-3


def config():
    """Reduced granite-moe (d 256, 4 experts, top 2, 2 layers), f32."""
    return get_config(ARCH + "-reduced").replace(dtype="float32")


def run_config():
    return RunConfig(arch=ARCH, lr=LR, total_steps=10, warmup=0)


def model_from(inp):
    return convert.model_params_from_jax(config(), inp["model_params"],
                                         "cpu")


def train_loss(model, params, batch, mesh):
    """``steps.make_train_step``'s loss (``steps.train_loss``): chunked CE
    plus the weighted moe aux; on a live ``mesh`` the step's own
    per-rank loss."""
    return steps.train_loss(model, params, batch, mesh)


def _collectives(mesh):
    """psum / pmean / all_gather (stacked and tiled) and shard_map's
    entry and exit, each with a backward: the gradients a rank gets."""
    r = mesh.rank
    axes = ("data", "model")
    c = torch.arange(6, dtype=torch.float32).reshape(2, 3)   # every rank's
    out = {}
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    (partition.psum(x, axes, mesh) * c).sum().backward()
    out["psum"] = x.grad
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    (partition.pmean(x, axes, mesh) * c).sum().backward()
    out["pmean"] = x.grad
    # a partial cotangent: each rank weighs the gathered value by its own
    for name, kw in (("gather", {}), ("gather_tiled",
                                      {"axis": 1, "tiled": True})):
        x = torch.full((2, 3), float(r + 1), requires_grad=True)
        z = partition.all_gather(x, axes, mesh, **kw)
        w = torch.arange(z.numel(), dtype=torch.float32).reshape(z.shape)
        (z * w * (r + 1)).sum().backward()
        out[name] = (z.detach(), x.grad)
    # shard_map: a sharded input, a replicated one, a gathered output
    g = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    a, b = g.clone().requires_grad_(True), g.clone().requires_grad_(True)

    def body(a_blk, b_full):
        total = partition.psum((a_blk * a_blk).sum()
                               + (b_full * (r + 1)).sum(), axes, mesh)
        return 3.0 * a_blk, total

    gathered, total = partition.shard_map(
        body, mesh, in_specs=(("data", "model"), None),
        out_specs=(("data", "model"), ()))(a, b)
    (total + (gathered * c.repeat(2, 2)).sum()).backward()
    out["map"] = {"gathered": gathered.detach(), "total": total.detach(),
                  "grad_a": a.grad, "grad_b": b.grad}
    return out


def _layer(inp, meshes, worker_mesh):
    """apply_moe on each mesh: y, aux and the gradients of the layer's
    loss; and on a live mesh without the expert axis."""
    cfg = config()
    p = {k: torch.from_numpy(v) for k, v in inp["layer_p"].items()}
    x, cot = torch.from_numpy(inp["layer_x"]), torch.from_numpy(
        inp["layer_cot"])
    out = {}
    for name, mesh in meshes.items():
        live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        y, aux = moe.apply_moe(live, xl, cfg, mesh=mesh)
        (torch.sum(y * cot) + AUX_W * aux).backward()
        out[name] = {"y": y.detach(), "aux": float(aux),
                     "grads": {k: v.grad for k, v in live.items()},
                     "grad_x": xl.grad}
    y, aux = moe.apply_moe(p, x, cfg, mesh=worker_mesh)
    y1, aux1 = moe.apply_moe(p, x, cfg)
    out["no_expert_axis"] = {"equal": torch.equal(y, y1)
                             and torch.equal(aux, aux1)}
    return out


def _model(inp, meshes):
    """Model.apply(mesh=) on each mesh, decode_step(mesh=) at B = 1."""
    model = model_from(inp)
    tokens = torch.from_numpy(inp["tokens"])
    out = {"apply": {}, "decode": {}}
    with torch.no_grad():
        for name, mesh in meshes.items():
            logits, aux = model.apply({"tokens": tokens}, mesh=mesh)
            out["apply"][name] = {"logits": logits,
                                  "moe_aux": float(aux["moe_aux"])}
        for name in DECODE_SHAPES:
            cache = model.init_decode_cache(1, DECODE_STEPS)
            step = steps.make_serve_step(model, run_config(),
                                         mesh=meshes[name])
            logits = []
            for t in range(DECODE_STEPS):
                lg, cache = step(cache, {"tokens": tokens[:1, t],
                                         "pos": t})
                logits.append(lg)
            out["decode"][name] = torch.stack(logits)
    return out


def _train(inp, mesh):
    """On (data 2, model 2): the gradients of the step's loss, then one
    AdamW step of make_train_step(mesh=) and this rank's parameters."""
    model = model_from(inp)
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    run = run_config()
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    (loss, aux), grads = value_and_grad(
        lambda p, b: train_loss(model, p, b, mesh), state.params, batch)
    step = steps.make_train_step(model, opt, run, mesh=mesh)
    new, metrics = step(state, batch)
    pshard = steps.param_shardings(model, state.params, mesh)
    named = steps.make_state_shardings(state, state.params, pshard, mesh)
    shape = mesh_lib.Mesh(mesh.axis_names, mesh.axis_sizes)
    plain = steps.make_state_shardings(state, state.params, pshard, shape)
    return {"loss": float(loss), "ce": float(aux["ce"]),
            "moe_aux": float(aux["moe_aux"]), "grads": grads,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": new.params,
            "named_specs": _specs_of(named) == plain
            and _all_named(named, mesh)}


def _is_named(x):
    return isinstance(x, partition.NamedSharding)


def _specs_of(tree):
    """A tree of NamedSharding as the tree of their specs."""
    if _is_named(tree):
        return tree.spec
    if isinstance(tree, dict):
        return {k: _specs_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_specs_of(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return tree


def _all_named(tree, mesh):
    if _is_named(tree):
        return tree.mesh is mesh
    if isinstance(tree, dict):
        return all(_all_named(v, mesh) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_named(v, mesh) for v in tree)
    return tree is None


def _restore(inp, mesh):
    """The checkpoint restored with NamedShardings on (data 2, model 2):
    this rank's blocks."""
    target = {"params": {k: _zeros(v) for k, v in
                         inp["ckpt_shapes"].items()}}
    shardings = {"params": partition.named(mesh, inp["ckpt_specs"])}
    tree, step = restore_checkpoint(inp["ckpt_dir"], target,
                                    shardings=shardings)
    return {"step": step, "params": tree["params"]}


def _zeros(shapes):
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_zeros(v) for v in shapes]
    return torch.zeros(shapes)


def _loop(inp, mesh):
    """ClosedLoopTrainer over the worker mesh, one worker a rank."""
    clt = ClosedLoopTrainer(inp["loop_cfg"], inp["loop_x"], inp["loop_y"],
                            L0=inp["loop_L0"], device="cpu", mesh=mesh)
    L, hist = clt.run()
    return {"L": L, "hist": hist, "pool": dict(clt.source._pool),
            "lead": clt.engine is not None and clt.miner is not None,
            "timings": [sorted(t) for t in clt.timings],
            "n_refreshes": clt.n_refreshes}


def _ps_specs(mesh):
    """sync.state_sharding on a live mesh: NamedSharding pairs whose specs
    are those on no mesh."""
    cfg = sync.PSConfig(n_workers=N_RANKS)
    state = sync.init_state(optim.adam(0.1), torch.zeros(3, 5), cfg)
    named = sync.state_sharding(mesh, cfg, state)
    return _specs_of(named) == sync.state_sharding(None, cfg, state) \
        and _all_named(named, mesh)


def run_all(inp):
    """Every case of the test file on this rank, in one group of 4."""
    meshes = {name: mesh_lib.make_local_mesh(data=d, model=m)
              for name, (d, m) in SHAPES.items()}
    worker_mesh = sync.make_worker_mesh(N_RANKS)
    out = {"rank": meshes["2x2"].rank,
           "collectives": _collectives(meshes["2x2"]),
           "layer": _layer(inp, meshes, worker_mesh),
           "model": _model(inp, meshes),
           "train": _train(inp, meshes["2x2"]),
           "restore": _restore(inp, meshes["2x2"]),
           "ps_specs": _ps_specs(worker_mesh),
           "loop": _loop(inp, worker_mesh)}
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out
