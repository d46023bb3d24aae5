"""PyTorch/CUDA port of the ``repro`` distance-metric-learning system.

Mirrors ``repro``'s layout module for module; the JAX package stays the
reference and the tests hold each ported module against it. The port
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``device.resolve_device``); a CUDA tensor reaching a
kernel wrapper launches the hand-written Hopper kernel, a CPU tensor
takes the kernel's plain PyTorch version.
"""
