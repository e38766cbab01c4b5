"""Plain fp32 building blocks of the benchmark's reference.

The parameter and buffer names are those of the port's checkpoints, so
that one seeded state dict loads strictly into both.

BatchNorm follows PyTorch's rule: train mode normalises by the biased
batch variance and moves the running statistics by momentum 0.1 with the
unbiased one; eval mode uses the running statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def conv(x, weight, bias=None, stride=1, padding=0, groups=1):
    return F.conv2d(x, weight, bias, stride, padding, 1, groups)


def matmul(a, b):
    return a @ b


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class BatchNorm(nn.Module):
    """Over dim 1 of (B, C) or (B, C, H, W); the port's keys (no
    ``num_batches_tracked``)."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum = BN_MOMENTUM

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        if self.training:
            n = x.numel() // x.shape[1]
            mean = x.mean(dims)
            var = (x - mean.view(shape)).square().mean(dims)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * (n / max(n - 1, 1)),
                                       self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)


class Conv(nn.Module):
    """A conv's weight (and bias) under the port's names, applied by
    ``conv``."""

    def __init__(self, cin: int, cout: int, k, stride=1, padding=0,
                 bias: bool = False):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = matmul(x, self.weight.t())
        return y if self.bias is None else y + self.bias
