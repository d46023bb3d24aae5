"""Granite-3.0 1B-A400M — fine-grained MoE, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                 # per-expert FFN width
    vocab_size=49155,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    n_experts=32,
    top_k=8,
    tie_embeddings=True,
    attention="full",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
