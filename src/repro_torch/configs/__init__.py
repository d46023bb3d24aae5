"""Experiment and architecture configurations of the port."""

from repro_torch.configs.base import (ArchConfig, InputShape,  # noqa: F401
                                      RunConfig, reduced)
from repro_torch.configs.registry import get_config, list_configs  # noqa: F401
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: F401
