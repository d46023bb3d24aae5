"""Pixtral-12B — Pixtral-ViT vision encoder (stubbed per the modality
carve-out) feeding a Mistral-Nemo decoder [hf:mistralai/Pixtral-12B-2409].

``input_kind="embeddings"``: input_specs() provides precomputed patch
embeddings of shape (B, T, d_model); the vision tower + projector are the one
sanctioned stub. The language decoder below is fully implemented.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,              # nemo: explicit head_dim (32*128 != 5120)
    d_ff=14336,
    vocab_size=131072,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000_000.0,
    attention="full",
    input_kind="embeddings",
    source="hf:mistralai/Pixtral-12B-2409 (decoder = Mistral-Nemo-12B)",
)
