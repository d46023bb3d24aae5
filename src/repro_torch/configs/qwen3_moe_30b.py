"""Qwen3-30B-A3B — 128-expert top-8 MoE with QK-norm
[hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # per-expert FFN width
    vocab_size=151936,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    qk_norm=True,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    attention="full",
    source="hf:Qwen/Qwen3-30B-A3B",
)
