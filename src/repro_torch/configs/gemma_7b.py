"""Gemma-7B — GeGLU MLP, head_dim=256, embedding scaling [arXiv:2403.08295]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
    attention="full",
    source="arXiv:2403.08295 (Gemma)",
)
