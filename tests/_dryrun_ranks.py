"""The rank side of tests/test_torch_dryrun_ranks.py: what each gloo rank
runs under ``repro_torch.launch.mesh.spawn``.

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
from repro_torch.core.dml import DMLConfig
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.sharding import partition
from repro_torch.tree import tree_map

N_RANKS = 4
ARCH = "smollm-135m"
# the dense family's per-rank patterns at reduced width, f32:
#   dense: heads and kv heads over model (a decode cache over kv heads)
#   gqa:   1 kv head on a model axis of 2 (replicated; each rank keeps the
#          one its q heads read), the decode cache over its sequence
#   cp:    9 heads on 2 (context parallelism: each rank its slice of
#          every q chunk, at T past the chunked threshold; one layer, a
#          sequence a data rank), cache_seq too
CASES = {"dense": {},
         "gqa": {"n_heads": 4, "n_kv_heads": 1},
         "cp": {"n_heads": 9, "n_kv_heads": 3, "d_model": 144,
                "n_layers": 1, "attn_q_chunk": 512, "attn_kv_chunk": 512}}
SEQ = {"dense": 16, "gqa": 16, "cp": 2560}
BATCH = {"dense": 4, "gqa": 4, "cp": 2}
PREFILL_MESHES = {"dense": ("2x2", "1x4"), "gqa": ("2x2",), "cp": ("2x2",)}
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
DECODE_STEPS = 6
DECODE_LEN = 8
LR = 1e-3
DML = {"split": DMLConfig(feat_dim=16, proj_dim=8),
       "replicated": DMLConfig(feat_dim=16, proj_dim=7)}
DML_PAIRS = 6               # a data rank's


def config(case):
    return get_config(ARCH + "-reduced").replace(dtype="float32",
                                                  **CASES[case])


def run_config():
    return RunConfig(arch=ARCH, lr=LR, total_steps=10, warmup=0)


def model_from(inp, case):
    return convert.model_params_from_jax(config(case), inp["params"][case],
                                         "cpu")


def _collectives(mesh):
    """psum_scatter and the repaired all_gather with their backwards on
    (data 2, model 2): the values and gradients a rank gets."""
    r = mesh.rank
    out = {}
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) * (r + 1)
    x.requires_grad_(True)
    y = partition.psum_scatter(x, "model", mesh, scatter_dimension=0,
                               tiled=True)
    (y * (r + 1)).sum().backward()
    out["psum_scatter"] = (y.detach(), x.grad)
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    z = partition.all_gather(x, ("data", "model"), mesh, axis=1, tiled=True)
    (z * (r + 1)).sum().backward()
    out["gather"] = (z.detach(), x.grad)
    return out


def _prefill(inp, case, meshes):
    model = model_from(inp, case)
    tokens = torch.from_numpy(inp["tokens"][case])
    with torch.no_grad():
        return {name: model.apply({"tokens": tokens}, mesh=meshes[name])[0]
                for name in PREFILL_MESHES[case]}


def _train(inp, case, mesh):
    """One AdamW step of make_train_step(mesh=), and on rank 0 the
    one-process step from the same state."""
    model = model_from(inp, case)
    batch = {"tokens": torch.from_numpy(inp["tokens"][case]),
             "labels": torch.from_numpy(inp["labels"][case])}
    run = run_config()
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    new, metrics = steps.make_train_step(model, opt, run, mesh=mesh)(
        state, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": new.params, "m": new.opt_state.m}
    if mesh.rank == 0:
        one, one_metrics = steps.make_train_step(model, opt, run)(state,
                                                                  batch)
        out.update(one_metrics={k: float(v) for k, v in one_metrics.items()},
                   one_params=one.params, one_m=one.opt_state.m)
    return out


def _decode(inp, case, mesh):
    model = model_from(inp, case)
    tokens = torch.from_numpy(inp["tokens"][case])[:, :DECODE_STEPS]
    out = {}
    with torch.no_grad():
        for name, m in (("ranks", mesh), ("one", None)):
            cache = model.init_decode_cache(BATCH[case], DECODE_LEN)
            logits = []
            for t in range(DECODE_STEPS):
                lg, cache = model.decode_step(cache, tokens[:, t], t, mesh=m)
                logits.append(lg)
            out[name] = torch.stack(logits)
    return out


def _train_counted(inp, case, mesh):
    """The train step's body on this rank's own (contiguous) blocks
    under ``CostMode``: the collectives it issues."""
    model = model_from(inp, case)
    batch = {"tokens": torch.from_numpy(inp["tokens"][case]),
             "labels": torch.from_numpy(inp["labels"][case])}
    run = run_config()
    opt = steps.make_optimizer(run)
    state = steps.init_train_state(model, opt)
    rmap = steps.rank_train_map(model, opt, run, mesh, batch)
    blocks = partition.rank_blocks((state, batch), rmap.in_specs, mesh)
    mode = cost_analysis.CostMode()
    with mode:
        rmap.body(*blocks)
    return mode.collectives()


def _dml(inp, mesh):
    """The per-rank Eq. 4 step (rows of L over model when they divide
    it) and the one-process step, from the same L and pairs."""
    out = {}
    for name, dcfg in DML.items():
        L = torch.from_numpy(inp["dml"][name]["L"])
        batch = {k: torch.from_numpy(v)
                 for k, v in inp["dml"][name]["batch"].items()}
        _, specs = dryrun.dml_specs(dcfg, batch["xs"].shape[0], mesh)
        split = specs[0][0] is not None
        new, loss = dryrun._dml_step(dcfg, mesh, split)(
            *partition.rank_blocks((L, batch), specs, mesh))
        gathered = partition.all_gather(new, "model", mesh, tiled=True) \
            if split else new
        one, one_loss = dryrun._dml_step(dcfg)(L, batch)
        out[name] = {"split": split, "L": gathered, "loss": float(loss),
                     "one_L": one, "one_loss": float(one_loss)}
    return out


def run_all(inp):
    """Every rank-side case of the test file, in one group of 4."""
    meshes = {name: mesh_lib.make_local_mesh(data=d, model=m)
              for name, (d, m) in SHAPES.items()}
    mesh = meshes["2x2"]
    out = {"rank": mesh.rank, "collectives": _collectives(mesh),
           "prefill": {c: _prefill(inp, c, meshes) for c in CASES},
           "train": {c: _train(inp, c, mesh) for c in CASES},
           "decode": {c: _decode(inp, c, mesh) for c in CASES},
           "counted": _train_counted(inp, "dense", mesh),
           "dml": _dml(inp, mesh)}
    out = tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, out)
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out
