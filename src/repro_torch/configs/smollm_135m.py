"""SmolLM-135M — small llama-architecture dense model
[hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    attention="full",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
