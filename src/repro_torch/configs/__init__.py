"""Experiment and architecture configurations of the port."""

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.registry import get_config, list_configs  # noqa: F401
