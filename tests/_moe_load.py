"""Layer 0's expert loads of granite-moe-1b-a400m at full width (d_model
1024, 32 experts, top 8), one layer, f32, on the CPU: the reference's
``Model.init`` and its own layer-0 forward (embedding, attention block,
second norm, ``moe._route``), the port's forward on the same weights
(``convert.model_params_from_jax``), and the port's own seeded init. The
tokens are ``RandomState(16)``'s, as the card's layer check draws them.

    PYTHONPATH=src python tests/_moe_load.py [T]

prints, for each of the three, the tokens each expert receives (the
pairs routed to it), its largest and mean load, and the pairs that queues
at the config's capacity factor (2) drop.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models import moe as jax_moe

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import Model, attention, common, moe

NAME = "granite-moe-1b-a400m"


def _ref_topi(params, tokens, cfg):
    """The reference's routing of layer 0's MoE input, (N, k)."""
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    B, T = tokens.shape
    x = jax_common.embed_tokens(params["embedding"], jnp.asarray(tokens),
                                cfg, jnp.float32)
    h = jax_common.apply_norm(p0["norm1"], x, cfg)
    positions = jnp.arange(T, dtype=jnp.int32)[None, :].repeat(B, 0)
    q, k, v = jax_attention.qkv_proj(p0["attn"], h, positions, cfg)
    x = x + jax_attention.out_proj(
        p0["attn"], jax_attention.attend(q, k, v, cfg), cfg)
    h2 = jax_common.apply_norm(p0["norm2"], x, cfg)
    _, topi, _ = jax_moe._route(p0["moe"]["router"],
                                h2.reshape(B * T, -1), cfg)
    return np.asarray(topi)


def _port_topi(model, tokens):
    """The port's routing of layer 0's MoE input, (N, k)."""
    cfg = model.cfg
    p0 = model.blocks[0]
    B, T = tokens.shape
    tokens = torch.from_numpy(tokens)
    with torch.no_grad():
        x = common.embed_tokens(model.embedding, tokens, cfg, torch.float32)
        h = common.apply_norm(p0["norm1"], x, cfg)
        positions = torch.arange(T)[None, :].expand(B, T)
        q, k, v = attention.qkv_proj(p0["attn"], h, positions, cfg)
        x = x + attention.out_proj(
            p0["attn"], attention.attend_plain(q, k, v, cfg), cfg)
        h2 = common.apply_norm(p0["norm2"], x, cfg)
        _, topi, _ = moe._route(p0["moe"]["router"], h2.reshape(B * T, -1),
                                cfg)
    return topi.numpy()


def summary(topi, cfg):
    """Loads by expert, their max and mean, the pairs dropped at the
    config's capacity."""
    load = np.bincount(topi.reshape(-1), minlength=cfg.n_experts)
    cap = moe._capacity(topi.shape[0], cfg, cfg.n_experts)
    return {"load": load.tolist(), "max": int(load.max()),
            "mean": float(load.mean()), "capacity": cap,
            "dropped": int(np.maximum(load - cap, 0).sum())}


def layer0_routes(T: int, seed: int = 0):
    """(reference, port on the reference's weights, port's own init)
    routings of layer 0 at full width, one layer, B 1, and the config."""
    jcfg = jax_get_config(NAME).replace(n_layers=1, dtype="float32")
    cfg = get_config(NAME).replace(n_layers=1, dtype="float32")
    tokens = np.random.RandomState(16).randint(
        0, cfg.vocab_size, (1, T)).astype(np.int32)
    params = jax.tree.map(np.asarray,
                          jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    ref = _ref_topi(params, tokens, jcfg)
    same = _port_topi(model_params_from_jax(cfg, params, device="cpu"),
                      tokens)
    del params
    own = _port_topi(Model(cfg, device="cpu", seed=seed), tokens)
    return ref, same, own, cfg


def main():
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    ref, same, own, cfg = layer0_routes(T)
    print(f"{NAME} layer 0, full width, 1 layer, B 1, T {T}, f32, CPU; "
          f"routings equal (reference, port on its weights): "
          f"{bool((ref == same).all())}")
    for what, topi in (("reference init, reference forward", ref),
                       ("reference init, port forward", same),
                       ("port init, port forward", own)):
        print(f"{what}: {summary(topi, cfg)}")


if __name__ == "__main__":
    main()
