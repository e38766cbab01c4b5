"""Conv / norm blocks of the generator and the discriminators: port of
attngan_tpu/ops/layers.py.

Tensors are NCHW, kept in ``torch.channels_last`` memory so that
``x.permute(0, 2, 3, 1)`` is the zero-copy NHWC view the kernels take.
Weights stay fp32; convolutions run in the block's compute dtype, like
flax's ``dtype=`` (inputs and kernel cast, output in that dtype).

BatchNorm follows attngan_tpu/ops/layers.py::TorchBatchNorm: train mode
normalizes with the biased batch variance in fp32 and folds the unbiased
one into the running average (momentum 0.1, eps 1e-5: PyTorch's own rule);
eval mode folds the statistics into fp32 constants cast to x's dtype.
Under data parallelism (``parallel.mesh.sync_batch_norm_`` sets ``mesh``)
train mode takes the statistics of the global batch, as the JAX step does
under SPMD: the mean, then the mean squared deviation from it, each a sum
over the ranks (two-pass, as TorchBatchNorm computes them), through a
differentiable all-reduce; the running statistics then move alike on
every rank.

The JAX package's dilated and parity UpBlock forms (layers.py:174-248) are
XLA lowerings of the same function. Outside the kernel route the port runs
nearest upsample + conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.ops.cuda_upblock import upblock_fused_eval_cuda
from attngan_torch.ops.int8 import intercept
from attngan_torch.ops.cuda_upblock_packed import (
    CI as PACKED_CI,
    CO as PACKED_CO,
    upblock_fused_eval_packed_cuda,
)

BN_MOMENTUM = 0.1   # PyTorch's (new-stat weight); flax's 0.9 retain factor
BN_EPS = 1e-5


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit: first half * sigmoid(second half) along ``dim``."""
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), nn.Upsample(2, 'nearest')."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer``'s conv (its stride, padding and bias, if any) run in
    ``dtype``, or an int8 interceptor's site (ops/int8.py)."""
    out = intercept(layer, x)
    if out is not None:
        return out
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias,
                    stride=layer.stride, padding=layer.padding)


def conv3x3(in_features: int, out_features: int) -> nn.Conv2d:
    return nn.Conv2d(in_features, out_features, 3, padding=1, bias=False)


def conv4x4_down(in_features: int, out_features: int,
                 bias: bool = False) -> nn.Conv2d:
    """4x4 stride-2 conv, padding 1: halves H and W."""
    return nn.Conv2d(in_features, out_features, 4, stride=2, padding=1,
                     bias=bias)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def calculate_out_hw(hw: int, k: int, s: int, p: int = 0) -> int:
    """Conv output size: floor((hw + 2p - k) / s) + 1."""
    return (hw + 2 * p - k) // s + 1


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C) or (B, C, H, W) with TorchBatchNorm's
    semantics and fp32 parameters and statistics."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None    # parallel.mesh.Mesh of > 1 ranks: sync the stats

    def fold(self):
        """Eval-mode affine constants (k, b), fp32: y = x * k + b."""
        k = self.weight * torch.rsqrt(self.running_var + self.eps)
        return k, self.bias - self.running_mean * k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            k, b = self.fold()
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return x * k.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)
        if self.mesh is not None or x.numel() == x.shape[1]:
            # F.batch_norm refuses one value a channel; JAX's gives the bias
            return self._global_batch_norm(x)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, training=True,
                         momentum=BN_MOMENTUM, eps=self.eps)
        return y.to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the rows of every rank of ``self.mesh`` (or of
        this process's rows where it has none)."""
        from attngan_torch.parallel.mesh import all_reduce_sum

        def total(t: torch.Tensor) -> torch.Tensor:
            return t if self.mesh is None else all_reduce_sum(t, self.mesh)

        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        ranks = 1 if self.mesh is None else self.mesh.size
        n = xf.numel() // xf.shape[1] * ranks
        mean = total(xf.sum(dims)) / n
        centred = xf - mean.view(shape)
        var = total(centred.square().sum(dims)) / n
        with torch.no_grad():
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var * (n / max(n - 1, 1)), BN_MOMENTUM)
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class UpBlock(nn.Module):
    """2x nearest upsample -> conv3x3(2*out) -> BN -> GLU.

    ``fused_inference`` routes eval-mode forwards at >= 64^2 through a
    kernel, with the JAX meanings (attngan_tpu/ops/layers.py:282-303):
    True / "pallas" = K2 (ops/cuda_upblock.py); "packed" = K3
    (ops/cuda_upblock_packed.py) where Ci=64 -> Co=32 and the dims are
    even, else the plain chain; "packed64" = K3 only at a 64^2 input.
    """

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 fused_inference: bool | str = False):
        super().__init__()
        self.out_features = out_features
        self.dtype = dtype
        self.fused_inference = fused_inference
        self.conv = conv3x3(in_features, 2 * out_features)
        self.bn = BatchNorm(2 * out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ci, h, w = x.shape[1:]
        mode = self.fused_inference
        packed_ok = (ci == PACKED_CI and self.out_features == PACKED_CO
                     and h % 2 == 0 and w % 2 == 0)
        if mode == "packed64" and not (packed_ok and h == 64):
            mode = False
        if mode == "packed" and not packed_ok:
            mode = False
        if mode and not self.training and h >= 64:
            k, b = self.bn.fold()
            nhwc = x.to(self.dtype).permute(0, 2, 3, 1).contiguous()
            fn = (upblock_fused_eval_packed_cuda
                  if mode in ("packed", "packed64") else upblock_fused_eval_cuda)
            return fn(nhwc, self.conv.weight, k, b).permute(0, 3, 1, 2)
        x = conv(upsample_nearest_2x(x), self.conv, self.dtype)
        return glu(self.bn(x))


class ResBlock(nn.Module):
    """conv3x3(2c) -> BN -> GLU -> conv3x3(c) -> BN, plus the input."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv3x3(features, 2 * features)
        self.bn1 = BatchNorm(2 * features)
        self.conv2 = conv3x3(features, features)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = glu(self.bn1(conv(x, self.conv1, self.dtype)))
        y = self.bn2(conv(y, self.conv2, self.dtype))
        return y + x


class DownBlock(nn.Module):
    """conv4x4 stride 2 (no bias) -> BN -> LeakyReLU(0.2)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv4x4_down(in_features, out_features)
        self.bn = BatchNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.bn(conv(x, self.conv, self.dtype)))


class UpBlockReLU(nn.Module):
    """2x nearest upsample -> conv3x3 (no bias) -> BN -> ReLU."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv3x3(in_features, out_features)
        self.bn = BatchNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(conv(upsample_nearest_2x(x), self.conv,
                                   self.dtype)))


class DownBlockLeakyReLU(nn.Module):
    """conv4x4 stride 2 (with bias) -> BN -> LeakyReLU(0.2)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv4x4_down(in_features, out_features, bias=True)
        self.bn = BatchNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.bn(conv(x, self.conv, self.dtype)))


class Block3x3Relu(nn.Module):
    """conv3x3(2 * out) -> BN -> GLU, same spatial size."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv3x3(in_features, 2 * out_features)
        self.bn = BatchNorm(2 * out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(self.bn(conv(x, self.conv, self.dtype)))


class Block3x3LeakyRelu(nn.Module):
    """conv3x3 -> BN -> LeakyReLU(0.2), same spatial size."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv3x3(in_features, out_features)
        self.bn = BatchNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.bn(conv(x, self.conv, self.dtype)))


class ImageEncoder16x(nn.Module):
    """Four 4x4 stride-2 convs: (B, 3, H, W) -> (B, 8*df, H/16, W/16). The
    first has no BN; the others are conv -> BN -> LeakyReLU(0.2)."""

    def __init__(self, df_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = (3, df_dim, 2 * df_dim, 4 * df_dim, 8 * df_dim)
        self.conv = nn.ModuleList(conv4x4_down(a, b)
                                  for a, b in zip(widths, widths[1:]))
        self.bn = nn.ModuleList(BatchNorm(w) for w in widths[2:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(conv(x, self.conv[0], self.dtype))
        for layer, bn in zip(self.conv[1:], self.bn):
            x = leaky_relu(bn(conv(x, layer, self.dtype)))
        return x
