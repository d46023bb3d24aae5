"""RWKV-6 "Finch" 1.6B — attention-free RNN with data-dependent decay
[arXiv:2404.05892]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads: head_size 64 -> 2048/64
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    mlp_kind="rwkv_channel_mix",
    norm_kind="layernorm",
    attention="none",
    block_kind="rwkv6",
    source="arXiv:2404.05892 (Eagle and Finch: RWKV-5/6)",
)
