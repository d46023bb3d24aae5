"""Architecture registry — ``--arch <id>`` resolution (a copy of
``repro/configs/registry.py``)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs import (
    yi_6b, rwkv6_1_6b, zamba2_2_7b, command_r_35b, pixtral_12b,
    granite_moe_1b, qwen3_moe_30b, smollm_135m, hubert_xlarge, gemma_7b,
)

_ARCHS = {}
for _mod in (yi_6b, rwkv6_1_6b, zamba2_2_7b, command_r_35b, pixtral_12b,
             granite_moe_1b, qwen3_moe_30b, smollm_135m, hubert_xlarge,
             gemma_7b):
    _ARCHS[_mod.CONFIG.name] = _mod.CONFIG


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    if name not in _ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_ARCHS)}")
    return _ARCHS[name]


def list_configs():
    return sorted(_ARCHS)
