"""Carry the JAX package's weights (the DML factor and the backbone
models), a backbone's decode cache and training state, index arrays
(exact, IVF, IVFPQ, and a mutable index's state over any of them), a
tenant router's state, training state and a closed loop's configuration
across to the port.

Every function takes plain numpy arrays (``np.asarray`` of the
reference's ``jax.Array``s, e.g. ``jax.tree.map(np.asarray, state)``),
so this module imports nothing of JAX. Optimizer and PS states are
matched by their NamedTuple's class name and fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dml import DMLConfig
from repro_torch.core.ps.sync import PSConfig, PSState
from repro_torch.core.ps.trainer import DMLTrainConfig
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import check_metric_factor
from repro_torch.launch.steps import TrainState
from repro_torch.mining import (ClosedLoopConfig, CurriculumSchedule,
                                MinerConfig)
from repro_torch.models import Model
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.rwkv6 import RWKVCache
from repro_torch.models.transformer import unstack_blocks
from repro_torch.optim import AdamState, MomentumState, ScaleState
from repro_torch.serve.index import ExactIndex
from repro_torch.serve.ivf import IVFIndex
from repro_torch.serve.mutable import MutableIndex
from repro_torch.serve.pq import IVFPQIndex, ProductQuantizer
from repro_torch.serve.tenant import TenantRouter
from repro_torch.tree import tree_map

_OPT_STATES = {cls.__name__: cls for cls in
               (ScaleState, MomentumState, AdamState)}


def _tensor(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def metric_factor_from_jax(L_np, device=None) -> torch.Tensor:
    """The reference's (d_out, d_in) factor as an f32 tensor on ``device``
    (the card by default)."""
    L = torch.from_numpy(np.array(L_np, dtype=np.float32, copy=True))
    return check_metric_factor(L).to(resolve_device(device))


def exact_index_from_jax(L_np, gp_np, gn_np, device=None) -> ExactIndex:
    """A port ExactIndex over the arrays of a reference ExactIndex
    (``L``, ``gp``, ``gn``): no re-projection, the same rows bit for bit."""
    dev = resolve_device(device)
    return ExactIndex.from_projected(
        metric_factor_from_jax(L_np, dev),
        torch.from_numpy(np.array(gp_np, dtype=np.float32, copy=True)),
        torch.from_numpy(np.array(gn_np, dtype=np.float32, copy=True)),
        device=dev)


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _i32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32, copy=True))


def ivf_index_from_jax(L_np, centroids_np, gp_pad_np, gn_pad_np, ids_pad_np,
                       cap: int, n_clusters: int, nprobe: int, n_rows: int,
                       device=None, scan_impl: str = "auto") -> IVFIndex:
    """A port IVFIndex over the arrays of a single-device reference
    IVFIndex (``L``, ``centroids``, the padded segments ``gp_pad`` /
    ``gn_pad`` / ``ids_pad`` and its sizes): the same clusters and slots
    bit for bit, no re-clustering."""
    dev = resolve_device(device)
    C = int(n_clusters)
    gp_pad = _f32(gp_pad_np).reshape(C * int(cap), -1)
    return IVFIndex(
        L=metric_factor_from_jax(L_np, dev).contiguous(),
        centroids=_f32(centroids_np).to(dev),
        gp_pad=gp_pad.to(dev), gn_pad=_f32(gn_pad_np).reshape(-1).to(dev),
        ids_pad=_i32(ids_pad_np).reshape(-1).to(dev), cap=int(cap),
        n_clusters=C, nprobe=int(nprobe), n_rows=int(n_rows),
        scan_impl=scan_impl)


def pq_from_jax(codebooks_np, dim: int, device=None) -> ProductQuantizer:
    """A reference ProductQuantizer's codebooks (S, 2**bits, sub_dim) and
    input dim as the port's."""
    return ProductQuantizer(codebooks=_f32(codebooks_np).to(
        resolve_device(device)), dim=int(dim))


def ivfpq_index_from_jax(L_np, centroids_np, codebooks_np, dim: int,
                         codes_pad_np, t_pad_np, ids_pad_np, gp_full_np,
                         gn_full_np, cap: int, n_clusters: int, nprobe: int,
                         n_rows: int, rerank_depth: int = 50,
                         store: str = "device", device=None,
                         scan_impl: str = "auto") -> IVFPQIndex:
    """A port IVFPQIndex over the arrays of a reference IVFPQIndex (the
    codebooks, codes, t terms, ids and the full-precision rerank rows):
    the same codes bit for bit. ``store`` places the rerank rows on
    ``device`` or in host memory."""
    if store not in ("device", "host"):
        raise ValueError(f"unknown store {store!r} (device|host)")
    dev = resolve_device(device)
    pq = pq_from_jax(codebooks_np, dim, dev)
    S = pq.n_subspaces
    rows_dev = dev if store == "device" else torch.device("cpu")
    return IVFPQIndex(
        L=metric_factor_from_jax(L_np, dev).contiguous(),
        centroids=_f32(centroids_np).to(dev), pq=pq,
        codes_pad=torch.from_numpy(np.array(codes_pad_np, dtype=np.uint8,
                                            copy=True)).reshape(-1, S).to(dev),
        t_pad=_f32(t_pad_np).reshape(-1).to(dev),
        ids_pad=_i32(ids_pad_np).reshape(-1).to(dev),
        gp_full=_f32(gp_full_np).to(rows_dev),
        gn_full=_f32(gn_full_np).to(rows_dev), cap=int(cap),
        n_clusters=int(n_clusters), nprobe=int(nprobe), n_rows=int(n_rows),
        rerank_depth=int(rerank_depth), store=store, scan_impl=scan_impl)


def mutable_index_from_jax(mut_np_state: dict, device=None) -> MutableIndex:
    """A port MutableIndex in the state of a reference MutableIndex.

    ``mut_np_state`` holds numpy arrays and plain values under the
    reference's attribute names: ``base_type`` ("exact" | "ivf" |
    "ivfpq") and ``base``, the base's arrays and sizes as the keyword
    arguments of ``exact_`` / ``ivf_`` / ``ivfpq_index_from_jax`` (``L_np``,
    ``gp_np``, ...; ``device`` aside); then ``base_ids``, ``dead_base``,
    ``delta_gp``, ``delta_gn``, ``delta_ids``, ``dead_delta``,
    ``raw_base`` and ``raw_delta`` (None without retained rows),
    ``next_id``, ``version``, ``n_upserts``, ``n_deletes``,
    ``n_compactions``, ``n_rebuilds``, ``n_swaps``, ``base_kwargs``,
    ``auto_compact_delta`` and ``auto_compact_dead``. The base's arrays
    and the delta rows arrive bit for bit."""
    st = mut_np_state
    dev = resolve_device(device)
    build = {"exact": exact_index_from_jax, "ivf": ivf_index_from_jax,
             "ivfpq": ivfpq_index_from_jax}[st["base_type"]]
    base = build(**st["base"], device=dev)
    mut = MutableIndex(base, base.L, ids=st["base_ids"], raw=st["raw_base"],
                       base_kwargs=st["base_kwargs"],
                       auto_compact_delta=st["auto_compact_delta"],
                       auto_compact_dead=st["auto_compact_dead"])
    mut._restore(dead_base=st["dead_base"], delta_gp=st["delta_gp"],
                 delta_gn=st["delta_gn"], delta_ids=st["delta_ids"],
                 dead_delta=st["dead_delta"], raw_delta=st["raw_delta"],
                 next_id=st["next_id"], version=st["version"], counters=st)
    return mut


def tenant_router_from_jax(state: dict, device=None) -> TenantRouter:
    """A port TenantRouter in the state of a reference TenantRouter.

    ``state`` holds the reference's store and registrations as numpy
    arrays and plain values: ``rows`` (M, d_in), ``dead`` (M,) bool,
    ``generation``, ``k_top``, and ``tenants``, an ordered mapping of
    tenant name to its registration (``L``, ``backend``,
    ``build_kwargs``, ``k_top``, ``cache_size``, ``priority``,
    ``deadline_s``). The store arrives bit for bit on ``device`` (the
    card by default); every tenant starts cold, and its view builds on
    first use."""
    router = TenantRouter(state["rows"], device=device,
                          k_top=int(state["k_top"]))
    router._dead = np.array(state["dead"], dtype=bool, copy=True)
    router._generation = int(state["generation"])
    for name, reg in state["tenants"].items():
        router.add_tenant(name, reg["L"], backend=reg["backend"],
                          build_kwargs=reg["build_kwargs"],
                          k_top=reg["k_top"], cache_size=reg["cache_size"],
                          priority=reg["priority"],
                          deadline_s=reg["deadline_s"])
    return router


def opt_state_from_jax(state, device=None):
    """A reference optimizer state (``ScaleState`` / ``MomentumState`` /
    ``AdamState`` with numpy leaves, worker-stacked or not) as the port's
    state of the same name, leaves bit for bit on ``device``."""
    dev = resolve_device(device)
    cls = _OPT_STATES.get(type(state).__name__)
    if cls is None or tuple(getattr(state, "_fields", ())) != cls._fields:
        raise ValueError(f"not a ScaleState / MomentumState / AdamState: "
                         f"{type(state).__name__}")
    return cls(*(tree_map(lambda x: _tensor(x, dev), field)
                 for field in state))


def ps_state_from_jax(state, device=None) -> PSState:
    """A reference ``PSState`` (numpy leaves) as the port's: the
    worker-stacked params and optimizer states, the step and the SSP
    ring, bit for bit. The reference's PRNG key is dropped: the port
    takes the SSP delays as an input (``sync.make_train_step``)."""
    dev = resolve_device(device)
    ring = state.grad_ring
    return PSState(
        params=_tensor(state.params, dev),
        opt_state=opt_state_from_jax(state.opt_state, dev),
        step=int(np.asarray(state.step)),
        grad_ring=None if ring is None else _tensor(ring, dev))


def model_params_from_jax(cfg: ArchConfig, params_np, device=None) -> Model:
    """A port ``Model`` holding a reference ``Model.init`` tree (numpy
    leaves, e.g. ``jax.tree.map(np.asarray, params)``) bit for bit:
    ``embedding``, ``final_norm`` and ``shared`` as they are, the stacked
    ``blocks`` (leading ``layers`` axis) unstacked into one entry of the
    ``nn.ModuleList`` per layer."""
    dev = resolve_device(device)
    blocks = params_np["blocks"]
    params = {"embedding": tree_map(lambda x: _tensor(x, dev),
                                    params_np["embedding"]),
              "blocks": [tree_map(lambda x, i=i: _tensor(np.asarray(x)[i],
                                                         dev), blocks)
                         for i in range(cfg.n_layers)],
              "final_norm": tree_map(lambda x: _tensor(x, dev),
                                     params_np["final_norm"])}
    if "shared" in params_np:
        params["shared"] = tree_map(lambda x: _tensor(x, dev),
                                    params_np["shared"])
    return Model(cfg, device=dev, params=params)


_CACHES = {cls.__name__: cls for cls in (KVCache, MambaCache, RWKVCache)}


def _cache_list(stacked, dev) -> list:
    """A reference cache NamedTuple stacked on a leading layers (or
    groups) axis as the port's list of one cache a layer."""
    cls = _CACHES.get(type(stacked).__name__)
    if cls is None or tuple(stacked._fields) != cls._fields:
        raise ValueError(f"not a KVCache / MambaCache / RWKVCache: "
                         f"{type(stacked).__name__}")
    arrays = [np.asarray(a) for a in stacked]
    return [cls(*(_tensor(a[i], dev) for a in arrays))
            for i in range(len(arrays[0]))]


def decode_cache_from_jax(cfg: ArchConfig, cache_np, device=None) -> dict:
    """A reference ``Model.init_decode_cache`` / ``decode_step`` cache
    (numpy leaves) as the port's: the stacked ``blocks`` (and, for the
    hybrid family, ``shared``) caches become per-layer (per-group)
    lists, leaves bit for bit on ``device``; a mid-sequence cache
    carries a decode across."""
    dev = resolve_device(device)
    cache = {"blocks": _cache_list(cache_np["blocks"], dev)}
    if "shared" in cache_np:
        cache["shared"] = _cache_list(cache_np["shared"], dev)
    if len(cache["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(cache['blocks'])} layers of cache for "
                         f"{cfg.n_layers} layers")
    return cache


def train_state_from_jax(cfg: ArchConfig, state_np, device=None):
    """A reference ``steps.TrainState`` (numpy leaves: params, optimizer
    state, step) as (port ``Model``, port ``TrainState``): the model
    holds the params bit for bit (``model_params_from_jax``), the state's
    params are its ``param_tree()`` and the optimizer state's moments
    are unstacked into per-layer lists (``opt_state_from_jax``)."""
    dev = resolve_device(device)
    model = model_params_from_jax(cfg, state_np.params, dev)
    opt_state = opt_state_from_jax(unstack_blocks(state_np.opt_state), dev)
    step = torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32,
                        device=dev)
    return model, TrainState(model.param_tree(), opt_state, step)


def _torch_dtype(dt):
    """A numpy-convertible dtype (``jnp.float32``, ``jnp.bfloat16``, ...)
    as the torch dtype of the same name; None stays None."""
    return None if dt is None else getattr(torch, np.dtype(dt).name)


def closed_loop_config_from_jax(cfg) -> ClosedLoopConfig:
    """A reference ``ClosedLoopConfig`` as the port's, field by field:
    ``DMLConfig`` (its dtypes by name), ``PSConfig`` (with its worker
    axis name), ``DMLTrainConfig``,
    ``MinerConfig`` and ``CurriculumSchedule``. With the reference
    trainer's L0 (``ClosedLoopTrainer(..., L0=np.asarray(ref.L0))``) it
    carries a reference loop's starting state across."""
    d, ps, tr = cfg.train.dml, cfg.train.ps, cfg.train
    fields = lambda x: {f.name: getattr(x, f.name)  # noqa: E731
                        for f in dataclasses.fields(x)}
    train = DMLTrainConfig(
        dml=DMLConfig(feat_dim=d.feat_dim, proj_dim=d.proj_dim, lam=d.lam,
                      margin=d.margin, dtype=_torch_dtype(d.dtype),
                      compute_dtype=_torch_dtype(d.compute_dtype),
                      l_rank=d.l_rank),
        ps=PSConfig(n_workers=ps.n_workers, sync=ps.sync, tau=ps.tau,
                    staleness=ps.staleness, seed=ps.seed, axis=ps.axis),
        batch_size=tr.batch_size, steps=tr.steps, lr=tr.lr,
        log_every=tr.log_every)
    return ClosedLoopConfig(
        train=train, miner=MinerConfig(**fields(cfg.miner)),
        schedule=CurriculumSchedule(**fields(cfg.schedule)),
        index=cfg.index,
        index_kwargs=(None if cfg.index_kwargs is None
                      else dict(cfg.index_kwargs)),
        refresh_every=cfg.refresh_every,
        plateau_window=cfg.plateau_window, plateau_tol=cfg.plateau_tol,
        min_refresh_gap=cfg.min_refresh_gap, mine_queries=cfg.mine_queries)
