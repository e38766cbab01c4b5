"""attngan_torch: the PyTorch / CUDA port of attngan_tpu for one NVIDIA H100.

The JAX package (attngan_tpu) stays the reference; this package imports
nothing of it. Hand-written Hopper kernels live in csrc/ and are built at
first use (ops/_build.py); each has a plain PyTorch version beside it.
"""

__version__ = "0.1.0"
