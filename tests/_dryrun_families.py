"""The rank side of tests/test_torch_dryrun_families.py: what each gloo
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
# the families' per-rank patterns at reduced width (d 256, 2 layers), f32:
#   moe:   granite-moe, 4 experts (2 a rank over model), top 2, 4 q and
#          2 kv heads, tied vocab 512 over model
#   vlm:   pixtral, patch embeddings in (frontend_proj), GQA 4/2, its
#          own unembedding; decodes on tokens
#   audio: hubert, frame embeddings in, non-causal, attention and MLP
#          biases, LayerNorm; a vocab of 510 splits over a model axis of
#          2 and stays whole on 4 (hubert's 504 on 16)
ARCHS = {"moe": "granite-moe-1b-a400m", "vlm": "pixtral-12b",
         "audio": "hubert-xlarge"}
CASES = {"moe": {}, "vlm": {}, "audio": {"vocab_size": 510}}
PREFILL_MESHES = {"moe": ("2x2", "1x4"), "vlm": ("2x2",),
                  "audio": ("2x2", "1x4")}
DECODES = ("moe", "vlm")
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
    """The case's batch: tokens, or frame / patch embeddings (vlm,
    audio), with labels for training."""
    key = "tokens" if case == "moe" else "embeddings"
    out = {key: torch.from_numpy(inp[key][case])}
    if labels:
        out["labels"] = torch.from_numpy(inp["labels"][case])
    return out


def train_loss(model, params, batch):
    """``steps.make_train_step``'s loss on one process: chunked CE plus
    the weighted moe aux."""
    h, aux = model.hidden(batch, plain=True, params=params)
    ce = steps.chunked_ce_loss(model, params, h, batch["labels"])
    return ce + model.cfg.moe_aux_weight * aux["moe_aux"]


def _prefill(inp, case, meshes):
    model = model_from(inp, case)
    batch = batch_of(inp, case, labels=False)
    out = {}
    with torch.no_grad():
        for name in PREFILL_MESHES[case]:
            logits, aux = model.apply(batch, mesh=meshes[name])
            out[name] = {"logits": logits, "moe_aux": float(aux["moe_aux"])}
    return out


def _train(inp, case, mesh):
    """One AdamW step of make_train_step(mesh=) on ``mesh``; on rank 0
    the one-process step's gradient from the same state: of the whole
    batch's loss, or for the moe (capacity per batch shard, two batch
    shards on (2, 2)) of the mean over the two batch halves."""
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
        parts = [batch] if case != "moe" else \
            [{k: v[:BATCH // 2] for k, v in batch.items()},
             {k: v[BATCH // 2:] for k, v in batch.items()}]

        def loss(params, _):
            return sum(train_loss(model, params, b) for b in parts) \
                / len(parts), {}

        (value, _), grads = value_and_grad(loss, state.params, None)
        out.update(one_loss=float(value), one_grads=grads)
    return out


def _decode(inp, case, mesh):
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
    blocks = partition.rank_blocks((state, batch), rmap.in_specs, mesh)
    mode = cost_analysis.CostMode()
    with mode:
        rmap.body(*blocks)
    return mode.collectives()


def run_all(inp):
    """Every rank-side case of the test file, in one group of 4."""
    meshes = {name: mesh_lib.make_local_mesh(data=d, model=m)
              for name, (d, m) in SHAPES.items()}
    mesh = meshes["2x2"]
    out = {"rank": mesh.rank,
           "prefill": {c: _prefill(inp, c, meshes) for c in CASES},
           "train": {c: _train(inp, c, mesh) for c in CASES},
           # hubert's vocab whole on every rank of a model axis of 4
           "train_1x4": {"audio": _train(inp, "audio", meshes["1x4"])},
           "decode": {c: _decode(inp, c, mesh) for c in DECODES},
           "counted": _train_counted(inp, "moe", mesh)}
    out = tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, out)
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out
