"""Zamba2-2.7B — Mamba2 backbone with interleaved *shared* attention blocks
[arXiv:2411.15242]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    mlp_kind="gelu",
    norm_kind="rmsnorm",
    attention="full",          # the shared block uses full attention
    block_kind="mamba2",
    ssm_state=64,
    ssm_heads=80,              # mamba head_dim 64: 2*2560/64 = 80 heads
    ssm_expand=2,
    conv_width=4,
    shared_attn_every=6,       # one shared attn+mlp block every 6 mamba layers
    # §Perf A winners: chunk 128 + bf16 tiles + ordered contractions
    # (memory term 264s -> 66.6s, per-chip temp 62 GiB -> 5.7 GiB)
    ssm_chunk=128,
    ssm_tile_dtype="bfloat16",
    source="arXiv:2411.15242 (Zamba2 technical report)",
)
