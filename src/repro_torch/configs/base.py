"""Architecture / run configuration dataclasses and the reduction rule
used by smoke tests (2 layers, d_model <= 512, <= 4 experts).

A copy of ``repro/configs/base.py`` (``ArchConfig``, ``reduced``,
``InputShape``, ``RunConfig``): the port keeps its own configs and
imports nothing of ``repro``."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One backbone architecture. Field defaults follow llama conventions;
    every assigned config overrides explicitly and cites its source."""

    name: str
    family: str                  # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: Optional[int] = None     # None -> MHA
    head_dim: Optional[int] = None       # None -> d_model // n_heads

    # block structure
    mlp_kind: str = "swiglu"             # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    parallel_block: bool = False         # command-r: attn & mlp in parallel
    embed_scale: bool = False            # gemma: embeddings * sqrt(d_model)
    qk_norm: bool = False
    attn_bias: bool = False

    # attention
    attention: str = "full"              # full | sliding | none
    window: int = 4096                   # sliding-window width
    causal: bool = True                  # False for encoder-only
    attn_q_chunk: int = 1024             # flash-chunk sizes (perf knobs)
    attn_kv_chunk: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 2.0     # expert queue slack (perf knob)

    # SSM (mamba2-style) / rwkv6
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256                 # SSD chunk length (perf knob)
    ssm_tile_dtype: str = "float32"      # intra-chunk decay-tile dtype
    block_kind: str = "attn"             # attn | mamba2 | rwkv6 (per-layer default)

    # hybrid (zamba2): a shared attention block is interleaved every N layers
    shared_attn_every: int = 0
    shared_attn_window: int = 4096

    # modality frontend (audio/vlm carve-out): model consumes embeddings
    input_kind: str = "tokens"           # tokens | embeddings

    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    source: str = ""                     # citation for the config

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def dim_per_head(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def has_decode(self) -> bool:
        """Encoder-only architectures have no autoregressive decode step."""
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """Whether long_500k decode is admissible (see DESIGN.md §5)."""
        return (self.family in ("ssm", "hybrid")
                or self.attention in ("sliding", "none"))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/block structure, tiny dimensions."""
    d_model = min(cfg.d_model, 256)
    n_heads = max(2, min(cfg.n_heads, 4))
    kv = cfg.kv_heads
    n_kv = max(1, min(kv, n_heads if kv >= cfg.n_heads else 2))
    head_dim = max(16, d_model // n_heads)
    kw = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim if cfg.head_dim is not None else None,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        window=min(cfg.window, 64),
        shared_attn_window=min(cfg.shared_attn_window, 64),
    )
    if cfg.n_experts:
        kw["n_experts"] = min(cfg.n_experts, 4)
        kw["top_k"] = min(cfg.top_k, 2)
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
    if cfg.ssm_heads:
        kw["ssm_heads"] = max(1, min(cfg.ssm_heads, 4))
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
    return cfg.replace(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One benchmark input shape (assigned set of 4)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Launcher-level knobs: optimization, distribution, logging."""
    arch: str = "smollm-135m"
    shape: str = "train_4k"
    lr: float = 3e-4
    opt: str = "adamw"
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 1000
    seed: int = 0
    # distribution
    multi_pod: bool = False
    sync: str = "bsp"            # PS consistency model for data-parallel sync
    tau: int = 1
    # memory / perf
    remat: bool = True           # activation checkpointing across layers
    scan_layers: bool = True
    ckpt_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
