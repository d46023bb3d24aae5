"""Yi-6B — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=5_000_000.0,
    attention="full",
    source="arXiv:2403.04652 (Yi: Open Foundation Models)",
)
