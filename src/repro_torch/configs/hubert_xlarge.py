"""HuBERT-XLarge — encoder-only audio transformer (wav2vec2 architecture)
[arXiv:2106.07447].

``input_kind="embeddings"``: the mel/conv feature extractor is the sanctioned
stub; input_specs() provides precomputed frame embeddings (B, T, d_model).
Encoder-only: no causal mask and NO decode step (decode shapes skipped —
see DESIGN.md §5). vocab_size=504 is the masked-unit prediction codebook.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    mlp_kind="gelu",
    norm_kind="layernorm",
    attn_bias=True,
    causal=False,
    attention="full",
    input_kind="embeddings",
    source="arXiv:2106.07447 (HuBERT)",
)
