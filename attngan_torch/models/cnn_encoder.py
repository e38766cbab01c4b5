"""Inception-v3 DAMSM image encoder: port of attngan_tpu/models/cnn_encoder.py.

A frozen Inception-v3 trunk (bilinear resize to 299x299 inside the forward,
align_corners=False; regions tapped at Mixed_6e, 17x17x768; Mixed_7c mean
pooled to 2048) and two trainable heads: a bias-free 1x1 conv 768 -> D on
the regions and a Linear 2048 -> D on the pooled code, both initialised
U(-0.1, 0.1). Images enter in [-1, 1] with no Inception renormalisation,
as in the JAX package.

The blocks are the torchvision-keyed modules of tests/torch_oracles.py,
copied here, so a torchvision state_dict (minus ``num_batches_tracked``,
``AuxLogits`` and ``fc``) loads by name. BatchNorm is the port's
(ops/layers.py::BatchNorm) with Inception's eps 1e-3. The JAX package's
stem relayouts (``packed_stem``, ``s2d_stem``) and sibling fusion
(``_fused_siblings``) are XLA lowerings of these same convs; the port runs
the plain convs through cuDNN.

Layouts: the encoders take NHWC images (B, H, W, 3), the JAX package's
layout, and view them as NCHW in channels_last memory (no copy); the trunks
take and return NCHW. A trunk computes in ``dtype``: the input is cast
before the resize and every conv casts its weight, as flax's ``dtype=``.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.ops.int8 import intercept
# BN_MOMENTUM: PyTorch's convention, the weight of the new statistic, 0.1:
# 1 - the JAX package's retain factor of 0.9 (its cnn_encoder.BN_MOMENTUM)
from attngan_torch.ops.layers import BN_MOMENTUM, BatchNorm  # noqa: F401

INCEPTION_BN_EPS = 1e-3   # torchvision BasicConv2d


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), half-pixel centres, as
    jax.image.resize(..., "bilinear"): antialiased where it shrinks."""
    if x.shape[-2:] == (size, size):
        return x
    shrink = x.shape[-2] > size or x.shape[-1] > size
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=shrink)


def _he_init_(conv: nn.Conv2d) -> None:
    # a seeded random trunk keeps O(1) activations through ~20 conv+ReLU
    # layers (the pretrained weights are not in the repository)
    nn.init.kaiming_normal_(conv.weight, nonlinearity="relu")


class BasicConv2d(nn.Module):
    """conv (no bias) -> BN (eps 1e-3) -> relu, in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, bias=False, **kw)
        self.bn = BatchNorm(out_ch, eps=INCEPTION_BN_EPS)
        _he_init_(self.conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = intercept(c, x)
        if y is None:
            y = F.conv2d(x, c.weight.to(x.dtype), stride=c.stride,
                         padding=c.padding)
        return F.relu(self.bn(y))


def _avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(x, 3, stride=1, padding=1), padded zeros counted in the
    mean: the 3x3 window sums as a depthwise conv of ones, then / 9.

    Not F.avg_pool2d: on CUDA its gradient for a channels_last input is
    wrong (torch 2.11 with CUDA 12.8, H100: 104% of the true gradient's
    norm off, in fp32 and fp64; NCHW inputs and the CPU are right), and the
    GAN step differentiates through the trunk into its images. The conv
    and its scale are also 3.7-4.4x faster there on the trunk's bf16
    channels_last maps at batch 64 (attngan_torch/tools/trunk_gradient.py,
    H100 80GB HBM3 at 700 W)."""
    c = x.shape[1]
    ones = torch.ones((c, 1, 3, 3), dtype=x.dtype, device=x.device)
    return F.conv2d(x, ones, padding=1, groups=c) * (1.0 / 9.0)


class InceptionA(nn.Module):
    # the 1x1 heads that JAX's eval trunk runs as one folded conv on the
    # raw kernels (attngan_tpu/models/cnn_encoder.py::_fused_siblings):
    # no int8 site there (infer/quantize.py::trunk_sites)
    FUSED_SIBLINGS = ("branch1x1", "branch5x5_1", "branch3x3dbl_1")

    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3x3(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, bd, bp], 1)


class InceptionC(nn.Module):
    FUSED_SIBLINGS = ("branch1x1", "branch7x7_1", "branch7x7dbl_1")

    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(_avg_pool3x3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    FUSED_SIBLINGS = ("branch3x3_1", "branch7x7x3_1")

    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, b7, bp], 1)


class InceptionE(nn.Module):
    FUSED_SIBLINGS = ("branch1x1", "branch3x3_1", "branch3x3dbl_1")

    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avg_pool3x3(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3Trunk(nn.Module):
    """Stem through Mixed_7c, tapping Mixed_6e: NCHW (B, 3, H, W) in [-1, 1]
    -> (regions (B, 768, 17, 17), pooled (B, 2048)), in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # cast BEFORE the resize, as the JAX trunk does
        x = resize_bilinear(x.to(self.dtype), 299)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        regions = x                                 # (B, 768, 17, 17)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return regions, x.mean(dim=(2, 3))          # avg_pool2d(k=8)


class TinyTrunk(nn.Module):
    """Three convs with InceptionV3Trunk's output contract ((B, 2w, 17, 17)
    regions, (B, 2w) pooled), after a resize to 68x68. Conv_i are the flax
    module's auto-names."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(3, width, 3, stride=2, padding=1)
        self.Conv_1 = nn.Conv2d(width, 2 * width, 3, stride=2, padding=1)
        self.Conv_2 = nn.Conv2d(2 * width, 2 * width, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = resize_bilinear(x.to(self.dtype), 68)
        for c in (self.Conv_0, self.Conv_1, self.Conv_2):
            y = intercept(c, x)
            if y is None:
                y = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype),
                             stride=c.stride, padding=c.padding)
            x = F.relu(y)
        return x, x.mean(dim=(2, 3))


class _Encoder(nn.Module):
    """A trunk and the trainable heads: NHWC images (B, H, W, 3) ->
    (region features (B, 289, D), cnn_code (B, D)), both fp32. The heads
    compute in the trunk's dtype, as the JAX encoder's."""

    def __init__(self, trunk: nn.Module, region_features: int,
                 pooled_features: int, out_dim: int):
        super().__init__()
        self.trunk = trunk
        self.emb_features = nn.Conv2d(region_features, out_dim, 1, bias=False)
        self.emb_cnn_code = nn.Linear(pooled_features, out_dim)
        nn.init.uniform_(self.emb_features.weight, -0.1, 0.1)
        nn.init.uniform_(self.emb_cnn_code.weight, -0.1, 0.1)
        nn.init.zeros_(self.emb_cnn_code.bias)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.heads(*self.trunk(images.permute(0, 3, 1, 2)))

    def heads(self, regions: torch.Tensor, pooled: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The heads on a trunk's outputs, in the trunk's dtype."""
        dt = regions.dtype
        regions = F.conv2d(regions, self.emb_features.weight.to(dt))
        code = F.linear(pooled, self.emb_cnn_code.weight.to(dt),
                        self.emb_cnn_code.bias.to(dt))
        b, d = regions.shape[:2]
        regions = regions.permute(0, 2, 3, 1).reshape(b, -1, d)
        return regions.float(), code.float()


class CNNEncoder(_Encoder):
    def __init__(self, out_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(InceptionV3Trunk(dtype), 768, 2048, out_dim)


class TinyCNNEncoder(_Encoder):
    """The small test / dev encoder with CNNEncoder's interface."""

    def __init__(self, out_dim: int = 256, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__(TinyTrunk(width, dtype), 2 * width, 2 * width,
                         out_dim)


def make_image_encoder(name: str, out_dim: int,
                       dtype: torch.dtype = torch.float32) -> _Encoder:
    """'inception_v3' (reference parity) or 'tiny'."""
    if name == "inception_v3":
        return CNNEncoder(out_dim, dtype)
    if name == "tiny":
        return TinyCNNEncoder(out_dim, dtype=dtype)
    raise ValueError(f"unknown image encoder {name!r}")


class _FoldedConv(nn.Module):
    """An eval-mode conv (+ folded BN) (+ relu) with its weights already in
    the compute dtype."""

    def __init__(self, weight, bias, stride, padding, relu: bool):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)
        self.stride, self.padding, self.relu = stride, padding, relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return F.relu(y) if self.relu else y


def freeze_trunk(trunk: nn.Module, device: torch.device | str | None = None
                 ) -> nn.Module:
    """A frozen eval-mode copy of ``trunk`` for the training step: each
    conv + BN folded into one conv with a bias, relu(conv(x, w * k) + b),
    the form the JAX trunk computes for its fused sibling convs, with the
    weights cast once to the trunk's dtype, on ``device``, in channels_last
    memory. The copy computes the eval trunk's function; the trunk itself
    is left as it is."""
    frozen = copy.deepcopy(trunk).eval().requires_grad_(False)
    dtype = getattr(trunk, "dtype", torch.float32)
    for name, module in list(frozen.named_modules()):
        if isinstance(module, BasicConv2d):
            k, b = module.bn.fold()
            w = module.conv.weight * k[:, None, None, None]
            folded = _FoldedConv(w.to(dtype), b.to(dtype), module.conv.stride,
                                 module.conv.padding, relu=True)
        elif isinstance(module, nn.Conv2d) and isinstance(frozen, TinyTrunk):
            folded = _FoldedConv(module.weight.to(dtype),
                                 module.bias.to(dtype), module.stride,
                                 module.padding, relu=False)
        else:
            continue
        parent, _, attr = name.rpartition(".")
        setattr(frozen.get_submodule(parent) if parent else frozen, attr,
                folded)
    if device is not None:
        frozen = frozen.to(device)
    return frozen.to(memory_format=torch.channels_last)
