"""Backbone models of the port (dense, ssm and hybrid families): the
full-sequence forward and decode of ``repro/models``, with Mamba2's SSD
core and attention on the hand-written Hopper kernels on the card."""

from repro_torch.models.transformer import Model  # noqa: F401
