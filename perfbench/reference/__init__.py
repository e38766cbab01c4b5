"""The plain fp32 PyTorch reference that decides ``correct``.

A copy of AttnGAN's functions as the port defines them, written apart from
the port: it imports nothing of ``attngan_torch`` (nor JAX), runs no kernel
and takes no weight, statistic or table that the port has made. Its
modules carry the port's parameter names, so that one seeded state dict
loads strictly into both.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """True fp32 products (TF32 off) inside, the flags restored after, so
    that the port runs under its own settings."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
