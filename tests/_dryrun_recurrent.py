"""The rank side of tests/test_torch_dryrun_recurrent.py: what each gloo
rank runs under ``repro_torch.launch.mesh.spawn``.

Kept apart from the test file, which imports jax: a spawned rank imports
the module its function lives in, and the ranks import torch and
``repro_torch`` only (``run_all`` reports any jax or ``repro`` module
found loaded). Every function returns host values for the test process
to hold against the reference and the one-process oracle.
"""

import sys

import torch

from repro_torch import convert
from repro_torch.configs import RunConfig, get_config
from repro_torch.launch import cost_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.sharding import partition
from repro_torch.tree import tree_map, value_and_grad

N_RANKS = 4
# the recurrent families at reduced width (d 256), f32:
#   ssm:    rwkv6, 16 heads of 16 (past the cache rule's 8 heads, so the
#           wkv state is sharded over its key dim, as at full width), 2
#           layers
#   hybrid: zamba2, 4 mamba2 heads of 128 (w_xbc's 544 columns split
#           off the heads), 4 layers: two uses of the shared block
ARCHS = {"ssm": "rwkv6-1.6b", "hybrid": "zamba2-2.7b"}
CASES = {"ssm": {"n_heads": 16, "head_dim": 16},
         "hybrid": {"n_layers": 4, "ssm_tile_dtype": "float32"}}
PREFILL_MESHES = ("2x2", "1x4")
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
BATCH, SEQ = 4, 16
DECODE_B, DECODE_STEPS, DECODE_LEN = 2, 4, 8
LR = 1e-3


def config(case):
    return get_config(ARCHS[case] + "-reduced").replace(dtype="float32",
                                                        **CASES[case])


def run_config(case):
    return RunConfig(arch=ARCHS[case], lr=LR, total_steps=10, warmup=0)


def model_from(inp, case):
    return convert.model_params_from_jax(config(case), inp["params"][case],
                                         "cpu")


def batch_of(inp, case, labels=True):
    out = {"tokens": torch.from_numpy(inp["tokens"][case])}
    if labels:
        out["labels"] = torch.from_numpy(inp["labels"][case])
    return out


def _prefill(inp, case, meshes):
    model = model_from(inp, case)
    batch = batch_of(inp, case, labels=False)
    out = {}
    with torch.no_grad():
        for name in PREFILL_MESHES:
            out[name] = model.apply(batch, mesh=meshes[name])[0]
        out["one"] = model.apply(batch)[0]
    return out


def _train(inp, case, mesh):
    """One AdamW step of make_train_step(mesh=) on ``mesh``; on rank 0
    the one-process step from the same state."""
    model = model_from(inp, case)
    batch = batch_of(inp, case)
    run = run_config(case)
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    new, metrics = steps.make_train_step(model, opt, run, mesh=mesh)(
        state, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": new.params, "m": new.opt_state.m}
    if mesh.rank == 0:
        one, one_metrics = steps.make_train_step(model, opt, run)(state,
                                                                  batch)
        out["one"] = {"metrics": {k: float(v) for k, v in
                                  one_metrics.items()},
                      "params": one.params, "m": one.opt_state.m}

        def loss(params, _):
            return steps.train_loss(model, params, batch)

        out["one_grads"] = value_and_grad(loss, state.params, None)[1]
    return out


def _decode(inp, case, mesh):
    """4 decode steps through ``Model.decode_step(mesh=)`` (the cache
    stacked under the plan's specs inside) and on one process; the
    last caches too."""
    model = model_from(inp, case)
    tokens = torch.from_numpy(inp["decode"][case])
    out = {}
    with torch.no_grad():
        for name, m in (("ranks", mesh), ("one", None)):
            cache = model.init_decode_cache(DECODE_B, DECODE_LEN)
            logits = []
            for t in range(DECODE_STEPS):
                lg, cache = model.decode_step(cache, tokens[:, t], t, mesh=m)
                logits.append(lg)
            out[name] = torch.stack(logits)
            out[name + "_cache"] = cache
    return out


def _train_counted(inp, case, mesh):
    """The train step's body on this rank's own (contiguous) blocks
    under ``CostMode``: the collectives it issues."""
    model = model_from(inp, case)
    batch = batch_of(inp, case)
    run = run_config(case)
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    rmap = steps.rank_train_map(model, opt, run, mesh, batch)
    pblocks, bblocks = partition.rank_blocks(
        (state.params, batch), (rmap.in_specs[0].params, rmap.in_specs[1]),
        mesh)
    mblocks = partition.rank_blocks(state.params,
                                    rmap.in_specs[0].opt_state.m, mesh)
    blocks = (steps.TrainState(pblocks, opt.init(mblocks), state.step),
              bblocks)
    mode = cost_analysis.CostMode()
    with mode:
        rmap.body(*blocks)
    return mode.collectives()


# partition.reblock's moves on (data 2, model 2): rwkv6's w_o moment
# (a dimension from model to data, and back through an all-to-all) and
# the wkv state's model axis from its key dim to its heads
REBLOCKS = ((("model", "data"), ("data", None)),
            (("data", None), ("model", "data")),
            ((None, "data", None, "model", None),
             (None, "data", "model", None, None)))
REBLOCK_SHAPES = ((8, 4), (8, 4), (1, 2, 4, 4, 3))


def _reblocks(mesh):
    """Each move of REBLOCKS on this rank's block of an arange."""
    out = []
    for (src, dst), shape in zip(REBLOCKS, REBLOCK_SHAPES):
        x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        out.append(partition.reblock(partition.block(x, src, mesh), src,
                                     dst, mesh))
    return out


def run_all(inp):
    """Every rank-side case of the test file, in one group of 4."""
    meshes = {name: mesh_lib.make_local_mesh(data=d, model=m)
              for name, (d, m) in SHAPES.items()}
    mesh = meshes["2x2"]
    out = {"rank": mesh.rank,
           "prefill": {c: _prefill(inp, c, meshes) for c in CASES},
           "train": {c: _train(inp, c, mesh) for c in CASES},
           "decode": {c: _decode(inp, c, mesh) for c in CASES},
           "counted": _train_counted(inp, "hybrid", mesh),
           "reblock": _reblocks(mesh), "coords": mesh.coords}
    out = tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, out)
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out
