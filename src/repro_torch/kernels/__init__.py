"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` is the public surface: each op launches its CUDA kernel on a CUDA
tensor (or raises) and runs its plain version from ``ref`` on a CPU tensor.
"""
