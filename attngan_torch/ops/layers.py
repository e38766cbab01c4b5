"""Conv / norm blocks of the generator and the discriminators: port of
attngan_tpu/ops/layers.py.

Tensors are NCHW, kept in ``torch.channels_last`` memory so that
``x.permute(0, 2, 3, 1)`` is the zero-copy NHWC view the kernels take.
Weights stay fp32; convolutions run in the block's compute dtype, like
flax's ``dtype=`` (inputs and kernel cast, output in that dtype).

BatchNorm follows attngan_tpu/ops/layers.py::TorchBatchNorm: train mode
normalizes with the biased batch variance in fp32 and folds the unbiased
one into the running average (momentum 0.1, eps 1e-5: PyTorch's own rule),
through F.batch_norm's fused kernels on the GPU and TorchBatchNorm's
two-pass sums on the CPU; eval mode folds the statistics into fp32
constants cast to x's dtype. The generator's eval BatchNorm -> GLU and
BatchNorm -> residual add (``BatchNorm.forward_glu`` / ``forward_add``)
run as one pass of K8 (ops/cuda_bn_epilogue.py) where its block's fused
switch is on (GanConfig.fused_upsample, which the exported plain path
clears) and the kernel takes them: eval mode, grad off, CUDA tensors in
channels_last (or (B, C)) of one type it takes; elsewhere, and always on
the CPU, as the chain above.
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

from attngan_torch.ops.cuda_bn_epilogue import bn_epilogue_cuda, takes
from attngan_torch.ops.cuda_upblock import upblock_fused_eval_cuda
from attngan_torch.ops.int8 import intercept
from attngan_torch.utils.timing import span
from attngan_torch.utils.training import calculate_out_hw

BN_MOMENTUM = 0.1   # PyTorch's (new-stat weight); flax's 0.9 retain factor
BN_EPS = 1e-5


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit: first half * sigmoid(second half) along ``dim``."""
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C) as it is, (B, C, H, W) as its NHWC view: channels last."""
    return x if x.dim() == 2 else x.permute(0, 2, 3, 1)


def _channels_first(y: torch.Tensor) -> torch.Tensor:
    return y if y.dim() == 2 else y.permute(0, 3, 1, 2)


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


def conv1x1(in_features: int, out_features: int,
            bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_features, out_features, 1, bias=bias)


def conv3x3(in_features: int, out_features: int) -> nn.Conv2d:
    return nn.Conv2d(in_features, out_features, 3, padding=1, bias=False)


def conv4x4_down(in_features: int, out_features: int,
                 bias: bool = False) -> nn.Conv2d:
    """4x4 stride-2 conv, padding 1: halves H and W."""
    return nn.Conv2d(in_features, out_features, 4, stride=2, padding=1,
                     bias=bias)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def solve_conv_params(in_hw: int, out_hw: int, max_kern: int = 4,
                      max_stride: int = 3, max_pad: int = 3):
    """(kernel, stride, pad) that map ``in_hw`` to exactly ``out_hw``,
    preferring a large kernel, then a large pad, then a large stride
    (reference utilities/layers.py:28-38 ``Layers.conv``)."""
    valid = [
        (k, s, p)
        for k in range(1, max_kern + 1)
        for s in range(1, max_stride + 1)
        for p in range(max_pad + 1)
        if calculate_out_hw(in_hw, k, s, p) == out_hw
    ]
    if not valid:
        raise ValueError(
            f"no (k, s, p) with k<={max_kern}, s<={max_stride}, p<={max_pad} "
            f"maps {in_hw} -> {out_hw}")
    return max(valid, key=lambda x: (x[0], x[2], x[1]))


def conv_for_output(in_features: int, out_features: int, in_hw: int,
                    out_hw: int, bias: bool = False, **limits) -> nn.Conv2d:
    """A conv whose (k, s, p) are solved to map ``in_hw`` to ``out_hw``."""
    k, s, p = solve_conv_params(in_hw, out_hw, **limits)
    return nn.Conv2d(in_features, out_features, k, stride=s, padding=p,
                     bias=bias)


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
        if self.mesh is not None or not x.is_cuda or x.numel() == x.shape[1]:
            # JAX's two-pass form off the GPU: on the CPU F.batch_norm sums
            # a channel in one running fp32 accumulator per thread, whose
            # rounding grows as the threads get fewer; it also refuses one
            # value a channel, where JAX's gives the bias
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

    def forward_glu(self, x: torch.Tensor, fused: bool = False
                    ) -> torch.Tensor:
        """``glu(self(x))`` over the channels (dim 1); with ``fused``, one
        K8 launch where the kernel takes it."""
        if fused and self._epilogue_takes(x):
            return _channels_first(bn_epilogue_cuda(
                _channels_last(x), *self._vectors(), self.eps))
        return glu(self(x))

    def forward_add(self, x: torch.Tensor, skip: torch.Tensor,
                    fused: bool = False) -> torch.Tensor:
        """``self(x) + skip``; with ``fused``, one K8 launch where the
        kernel takes it."""
        if fused and self._epilogue_takes(x, skip):
            return _channels_first(bn_epilogue_cuda(
                _channels_last(x), *self._vectors(), self.eps,
                _channels_last(skip)))
        return self(x) + skip

    def _vectors(self):
        return self.weight, self.bias, self.running_mean, self.running_var

    def _epilogue_takes(self, x: torch.Tensor,
                        skip: torch.Tensor | None = None) -> bool:
        """Whether K8 computes this eval epilogue (it has no backward)."""
        if self.training or torch.is_grad_enabled() or x.dim() not in (2, 4):
            return False
        return takes(_channels_last(x), self._vectors(),
                     None if skip is None else _channels_last(skip))


class UpBlock(nn.Module):
    """2x nearest upsample -> conv3x3(2*out) -> BN -> GLU.

    ``fused_inference`` runs eval-mode forwards at >= 64^2 as K2
    (ops/cuda_upblock.py), JAX's fused route (attngan_tpu/ops/layers.py:
    282-303), and the plain chain's BN -> GLU elsewhere as K8.
    """

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 fused_inference: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_inference = fused_inference
        self.conv = conv3x3(in_features, 2 * out_features)
        self.bn = BatchNorm(2 * out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("attngan.upblock"):
            if self.fused_inference and not self.training and x.shape[2] >= 64:
                k, b = self.bn.fold()
                nhwc = x.to(self.dtype).permute(0, 2, 3, 1).contiguous()
                return upblock_fused_eval_cuda(
                    nhwc, self.conv.weight, k, b).permute(0, 3, 1, 2)
            x = conv(upsample_nearest_2x(x), self.conv, self.dtype)
            return self.bn.forward_glu(x, self.fused_inference)


class ResBlock(nn.Module):
    """conv3x3(2c) -> BN -> GLU -> conv3x3(c) -> BN, plus the input;
    ``fused_inference`` runs the two BN epilogues as K8."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 fused_inference: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_inference = fused_inference
        self.conv1 = conv3x3(features, 2 * features)
        self.bn1 = BatchNorm(2 * features)
        self.conv2 = conv3x3(features, features)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = self.fused_inference
        y = self.bn1.forward_glu(conv(x, self.conv1, self.dtype), fused)
        return self.bn2.forward_add(conv(y, self.conv2, self.dtype), x, fused)


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
