"""Command-R 35B — Cohere dense decoder: parallel attn/FFN block, LayerNorm,
no biases, GQA kv=8 [hf:CohereForAI/c4ai-command-r-v01]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    mlp_kind="swiglu",
    norm_kind="layernorm",
    parallel_block=True,
    attn_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    attention="full",
    source="hf:CohereForAI/c4ai-command-r-v01",
)
