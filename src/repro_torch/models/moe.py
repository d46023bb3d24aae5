"""Mixture-of-Experts FFN: top-k router, grouped expert execution, and
the expert-parallel form over a live mesh (counterpart of
``repro/models/moe.py``).

``apply_moe`` routes every token of the batch, gives each (token, slot)
pair its place in its expert's queue in token-major order, drops the
pairs past ``capacity``, scatters the kept tokens into a capacity-bounded
(E, C, d) group buffer, runs the expert FFNs as batched products and
gathers the weighted outputs back, slot by slot. No (B, T, E, C)
dispatch tensor and no (N * k, d) gather is ever made.

``apply_moe_dense`` is the reference's oracle: every expert computes
every token, combined by the router's weights. Exact, E / k times the
products: what the tests and the card hold the grouped form against.

``apply_moe(mesh=...)`` on a ``launch/mesh.LiveMesh`` with the expert
axis (``model``) is the reference's expert-parallel path, one process a
rank: the layer runs inside ``sharding/partition.shard_map``, the batch
over whichever of ``pod`` / ``data`` divide B, the expert stacks
sharded over ``model`` and, when ``d_model`` divides ``data``, over
``data`` on their embed dims (FSDP). Its body is ``apply_moe_rank``
followed by one ``psum`` of the experts' partial outputs over
``model``. The map returns global values (its exit gathers ``y`` over
the batch axes), so the layer drops into a model that runs replicated
on every rank, and its gradients reach the global weights and
activations summed over the ranks (``partition.shard_map``'s
docstring). A named ``Mesh`` has no group, and it raises: a named
mesh's per-rank program runs in ``launch/mesh.fake_world``.

``apply_moe_rank`` is one rank's layer, also nested in a model's
per-rank program (``models/transformer.py``), where
``common.Ranks.reduce`` scatters its partial into the sequence-parallel
residual: the rank's ``E / M`` experts gathered over ``data``, every
token of its batch shard routed (the capacity taken per batch shard),
``aux`` pmeaned over ``model`` and the batch axes. Every rank's router
sorts its tokens the same way (the stable top-k below), so the ranks
agree on every pair's expert. No kernel: the reference computes the
layer with plain einsums, and so does the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._dispatch import full_f32
from repro_torch.models import common
from repro_torch.sharding import partition


def init_moe(cfg: ArchConfig, gen) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": common.normal_init(gen, (d, E), 0.02),
        "w_gate": common.he_init(gen, (E, d, f), d),
        "w_up": common.he_init(gen, (E, d, f), d),
        "w_down": common.he_init(gen, (E, f, d), f),
    }


def logical_axes(cfg: ArchConfig) -> dict:
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_ffn"),
        "w_up": ("experts", "embed", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "embed"),
    }


def _router_probs(router_w, x):
    """x (N,d) -> the router's probabilities (N,E) f32."""
    logits = (x @ router_w.to(x.dtype)).to(torch.float32)
    return torch.softmax(logits, dim=-1)


def _routed(probs, topi, cfg: ArchConfig):
    """The routing of each token to the experts ``topi`` (N,k) under the
    router's ``probs``: (their weights renormalized, topi, aux)."""
    topv = torch.gather(probs, 1, topi)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    # Switch-style load-balance loss over the local token set
    frac_tokens = torch.mean(
        F.one_hot(topi, cfg.n_experts).to(torch.float32), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=0)
    aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return topv, topi, aux


def _route(router_w, x, cfg: ArchConfig):
    """x (N,d) -> (topv (N,k) f32 renormalized, topi (N,k) int64, aux
    scalar f32)."""
    probs = _router_probs(router_w, x)
    # jax.lax.top_k breaks ties toward the lower expert index and
    # torch.topk does not. Ties are common: bf16 logits, a zero router.
    # A stable descending sort keeps the reference's order, and it is
    # deterministic, so a remat recomputation routes as the forward did.
    topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    return _routed(probs, topi[:, :cfg.top_k], cfg)


def _expert_ffn(p, xe, cfg: ArchConfig):
    """xe (E, C, d) against expert weight stacks (E, d, f); the stacks
    cast to the activation dtype at every call, as the reference does."""
    dt = xe.dtype
    g = torch.bmm(xe, p["w_gate"].to(dt))
    u = torch.bmm(xe, p["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(dt))


def _capacity(n_tokens: int, cfg: ArchConfig, n_local_experts: int,
              factor: float = None) -> int:
    factor = factor if factor is not None else cfg.moe_capacity_factor
    expect = n_tokens * cfg.top_k / cfg.n_experts
    c = int(factor * expect) + 8
    return max(8, (c + 7) // 8 * 8)


def _queue_slots(topi, e_offset: int, n_local_experts: int, capacity: int):
    """(keep (N*k,) bool, dest (N*k,) int64): each (token, slot) pair's
    row in the (n_local_experts * capacity + 1) group buffer. A pair's
    place in its expert's queue is a cumsum over the one-hot in the
    flattened token-major order, so the pairs past ``capacity`` (and the
    ones routed to experts of other shards) are the reference's, bit for
    bit; they go to the last row, the overflow bin."""
    local_e = topi - e_offset                                   # (N,k)
    is_local = (local_e >= 0) & (local_e < n_local_experts)
    flat_e = torch.where(is_local, local_e,
                         torch.full_like(local_e, n_local_experts)
                         ).reshape(-1)                          # (N*k,)
    # the one-hot laid out expert-major, (E_loc + 1, N*k), so the cumsum
    # runs along the innermost dim (a scan along the outer dim of an
    # (N*k, E_loc + 1) one-hot runs one thread a column on the card)
    experts = torch.arange(n_local_experts + 1, device=topi.device)
    onehot = (flat_e[None, :] == experts[:, None]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32)  # inclusive
    slot = torch.gather(pos_in_e, 0, flat_e[None, :])[0] - 1    # (N*k,)
    keep = (slot < capacity) & (flat_e < n_local_experts)
    dest = torch.where(keep, flat_e * capacity + slot,
                       torch.full_like(flat_e, n_local_experts * capacity))
    return keep, dest


def _moe_local(p_local, x, cfg: ArchConfig, e_offset: int,
               n_local_experts: int, capacity: int):
    """Grouped dispatch over the device-local token set and expert shard.

    p_local: expert weights already sliced to the local shard (E_loc, ...).
    x: (N, d) local tokens. e_offset: global id of first local expert.
    Returns (y_partial (N, d) — contributions of LOCAL experts only, aux).
    """
    N, d = x.shape
    k = cfg.top_k
    dt = x.dtype
    topv, topi, aux = _route(p_local["router"], x, cfg)
    keep, dest = _queue_slots(topi, e_offset, n_local_experts, capacity)

    # Dispatch and combine unrolled over the k routing slots, as the
    # reference: a single fused gather would make an (N*k, d) tensor.
    # Dispatch sets rows (kept pairs have rows of their own; dropped ones
    # all land in the overflow row, which is cut off); no float atomic.
    dest2 = dest.reshape(N, k)
    buf = x.new_zeros((n_local_experts * capacity + 1, d))
    for j in range(k):
        buf.index_put_((dest2[:, j],), x)
    xe = buf[:-1].reshape(n_local_experts, capacity, d)

    ye = _expert_ffn(p_local, xe, cfg)                          # (E_loc,C,d)

    # Combine gathers in slot order in the activation dtype. A dropped
    # pair reads the clamped last row with weight exactly 0, so in the
    # backward (an accumulating scatter) only exact zeros collide.
    yf = ye.reshape(n_local_experts * capacity, d)
    w2 = (topv * keep.reshape(N, k)).to(dt)                     # (N,k)
    src2 = torch.clamp(dest2, max=n_local_experts * capacity - 1)
    y = x.new_zeros((N, d))
    for j in range(k):
        y = y + yf[src2[:, j]] * w2[:, j, None]
    return y, aux


def apply_moe(p, x, cfg: ArchConfig, mesh=None, expert_axis: str = "model"):
    """x (B,T,d) -> (y (B,T,d), aux). Expert-parallel on a live mesh
    with the expert axis (every rank calls it with the same global p and
    x, and gets the global y and aux); single-device grouped dispatch
    without one."""
    full_f32()          # f32 configs: true f32 products, as the reference
    B, T, d = x.shape

    if mesh is None or expert_axis not in mesh.shape:
        cap = _capacity(B * T, cfg, cfg.n_experts)
        y, aux = _moe_local(p, x.reshape(B * T, d), cfg, 0, cfg.n_experts,
                            cap)
        return y.reshape(B, T, d), aux

    mesh = partition.require_live(mesh, "expert-parallel apply_moe")
    if expert_axis != "model":
        raise NotImplementedError(f"experts over {expert_axis!r}: the "
                                  f"port's expert map runs them over "
                                  f"'model'")
    n_shards = mesh.shape[expert_axis]
    if cfg.n_experts % n_shards:
        raise ValueError(f"{cfg.n_experts} experts do not divide the "
                         f"{n_shards} ranks of {expert_axis!r}")
    # shard the batch over whichever data-like axes divide it (B=1 decode
    # shapes leave the data axes idle)
    batch_axes = []
    prod = 1
    for a in ("pod", "data"):
        if a in mesh.shape and B % (prod * mesh.shape[a]) == 0:
            batch_axes.append(a)
            prod *= mesh.shape[a]
    # FSDP: the expert stacks come in sharded over `data` on their embed
    # dims and are all-gathered inside the body, as the reference does
    fsdp = "data" if "data" in mesh.shape and \
        d % mesh.shape["data"] == 0 else None
    pspec = {"router": (), "w_gate": (expert_axis, fsdp, None),
             "w_up": (expert_axis, fsdp, None),
             "w_down": (expert_axis, None, fsdp)}
    ranks = common.Ranks(mesh)

    def shard_fn(p_sh, x_sh):
        # x_sh: (B_loc, T, d), the same on every rank of the expert axis
        (y, _), aux = apply_moe_rank(p_sh, pspec, x_sh, cfg, ranks)
        return partition.psum(y, expert_axis, mesh), aux

    xspec = (tuple(batch_axes) if batch_axes else None,)
    fn = partition.shard_map(shard_fn, mesh=mesh, in_specs=(pspec, xspec),
                             out_specs=(xspec, ()), check_vma=False)
    return fn({k: p[k] for k in pspec}, x)


def apply_moe_rank(p, s, h, cfg: ArchConfig, ranks):
    """One rank's moe layer in the per-rank program: ``p`` its blocks of
    the specs ``s`` (the experts over ``model``, their embed dims over
    ``data``), ``h`` (B, T, d) its batch shard's whole sequence, the
    same on every ``model`` rank. Every rank routes every token of the
    shard, as the reference's ``shard_fn`` does (the capacity and the
    pairs kept are its), and runs its ``E / M`` experts on the stacks
    gathered over ``data``. Returns ((y, kind), aux): y the
    contributions of this rank's experts, a ``"partial"`` over
    ``model`` (``"full"`` when the experts are replicated), and aux
    pmeaned over ``model`` and the batch axes."""
    full_f32()
    w = {n: ranks.gather(p[n], s[n]) for n in p}
    e_loc = w["w_gate"].shape[0]
    split = ranks.on_model(s["w_gate"], 0)
    B, T, d = h.shape
    y, aux = _moe_local(w, h.reshape(B * T, d), cfg,
                        ranks.m * e_loc if split else 0, e_loc,
                        _capacity(B * T, cfg, e_loc))
    axes = ((ranks.model,) if ranks.model else ()) + ranks.batch
    if axes:
        aux = partition.pmean(aux, axes, ranks.mesh)
    return (y.reshape(B, T, d), "partial" if split else "full"), aux


def apply_moe_dense(p, x, cfg: ArchConfig):
    """Oracle: every expert computes every token; combine by router
    weights in f32."""
    full_f32()
    B, T, d = x.shape
    E = cfg.n_experts
    dt = x.dtype
    topv, topi, aux = _route(p["router"], x.reshape(B * T, d), cfg)
    combine = torch.sum(F.one_hot(topi, E).to(torch.float32)
                        * topv[..., None], dim=1)               # (N,E)
    xf = x.reshape(1, B * T, d).expand(E, B * T, d)
    ye = _expert_ffn(p, xf, cfg)                                # (E,N,d)
    y = torch.einsum("end,ne->nd", ye.to(torch.float32),
                     combine).to(dt)
    return y.reshape(B, T, d), aux
