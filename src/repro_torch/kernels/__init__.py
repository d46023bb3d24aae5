"""Hand-written Hopper kernels of the port, one package per kernel, each
with ``ref.py`` (plain PyTorch version), ``kernel.py`` (the ctypes-bound
CUDA wrapper), ``csrc/`` (the CUDA C++ source) and ``ops.py`` (the public
wrapper that dispatches by device)."""
