"""DF-GAN's generator: one stage from a 4x4 map to a 256x256 image, the
text fused into every block by per-sample affines.

Tao et al., "DF-GAN: A Simple and Effective Baseline for Text-to-Image
Synthesis", CVPR 2022 (arXiv:2008.05865); the layers of tobran/DF-GAN's
``code/models/GAN.py`` (``NetG``, ``G_Block``, ``DFBLK``, ``Affine``), with
its parameter names, so that its generator's state dict loads as it is:

  cond = concat(noise, sentence embedding)        (z_dim + emb_dim)
  x = fc(noise).view(B, 8 nf, 4, 4)               (the noise only)
  six GBlocks, 4^2 -> 256^2, channels nf * (8, 8, 8, 8, 4, 2, 1):
    up = upsample_nearest_2x(x)
    x = shortcut(up) + c2(DF(c1(DF(up; cond)); cond))
    shortcut: a 1x1 conv with bias where the channels change, else identity
  DF(x; cond) = lrelu(g1 * lrelu(g0 * x + b0) + b1), slope 0.2, each of
    g0, b0, g1, b1 its own MLP Linear(cond, C) -> ReLU -> Linear(C, C) of
    cond, broadcast over the pixels
  image = tanh(conv3x3(lrelu(x), 3))

How the port computes it: the MLPs in fp32, the convolutions in the
compute dtype (channels_last), each DF layer through K7
(ops/cuda_dfblock.py), the first of a block reading the block's input
before the upsample; the shortcut, a 1x1 conv or the identity, is the same
function at every pixel too, so it runs on that input and is added to the
block's output upsampled. The convs' biases ride on passes made anyway:
c1's in the next DF layer's first shift, c2's and c_sc's in the shortcut
before its upsample. No CondAugment, BatchNorm or word attention: the
word embeddings, the mask and eps that ``forward`` takes (the serving
path's one signature, models/generator.py's) are not read.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.core.config import GanConfig
from attngan_torch.core.runtime import compute_dtype
from attngan_torch.ops.cuda_dfblock import SLOPE, dfblock_cuda
from attngan_torch.ops.int8 import intercept, linear
from attngan_torch.ops.layers import conv
from attngan_torch.utils.timing import span

IMSIZE = 256


def channel_pairs(nf: int, imsize: int = IMSIZE) -> List[Tuple[int, int]]:
    """(in, out) channels of each GBlock (GAN.py's ``get_G_in_out_chs``)."""
    widths = [nf * min(2 ** k, 8) for k in range(int(math.log2(imsize)) - 1)]
    widths = widths[::-1]
    return list(zip(widths[:-1], widths[1:]))


def _mlp(cond_dim: int, features: int) -> nn.Sequential:
    return nn.Sequential(OrderedDict([
        ("linear1", nn.Linear(cond_dim, features)),
        ("relu1", nn.ReLU()),
        ("linear2", nn.Linear(features, features))]))


class Affine(nn.Module):
    """cond (B, cond_dim) -> (gamma, beta), each (B, C) fp32."""

    def __init__(self, cond_dim: int, features: int):
        super().__init__()
        self.fc_gamma = _mlp(cond_dim, features)
        self.fc_beta = _mlp(cond_dim, features)

    def forward(self, cond: torch.Tensor):
        return tuple(linear(mlp.linear2, F.relu(linear(mlp.linear1, cond)))
                     for mlp in (self.fc_gamma, self.fc_beta))


class DFBlock(nn.Module):
    """DF-GAN's DFBLK: affine -> LeakyReLU -> affine -> LeakyReLU, one K7
    launch. ``upsample``: x is the (B, C, H, W) map before a nearest 2x
    upsample, and the output is (B, C, 2H, 2W); ``size`` (Ho, Wo): before
    a nearest resize to that size (K7's resize form). ``shift`` (C,): the
    layer of x + shift, the shift folded into the first affine's (fp32) as
    b0 + g0 * shift."""

    def __init__(self, cond_dim: int, features: int):
        super().__init__()
        self.affine0 = Affine(cond_dim, features)
        self.affine1 = Affine(cond_dim, features)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                upsample: bool = False,
                shift: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        (g0, b0), (g1, b1) = self.affine0(cond), self.affine1(cond)
        if shift is not None:
            b0 = b0 + g0 * shift.float()
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        return dfblock_cuda(nhwc, g0, b0, g1, b1, upsample,
                            size).permute(0, 3, 1, 2)


def add_upsampled(x: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """x + upsample_nearest_2x(low), in place on x's channels_last storage
    (a copy first where x is not channels_last), ``low`` broadcast over a
    view of x's 2x2 pixels: no upsampled copy. At the dfgan-serve-b64
    cell's six blocks this add took 1.02 ms of device time a call, an
    upsampled copy and a vectorized add 2.07 ms (H100)."""
    b, c, h, w = low.shape
    out = x.permute(0, 2, 3, 1).contiguous()
    out.view(b, h, 2, w, 2, c).add_(
        low.permute(0, 2, 3, 1).reshape(b, h, 1, w, 1, c))
    return out.permute(0, 3, 1, 2)


def add_resized(x: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """x + nearest_resize(low) to x's size, in place on x's channels_last
    storage (a copy first where x is not channels_last): the resize that
    is not 2x, through F.interpolate's own index rule."""
    out = x.permute(0, 2, 3, 1).contiguous()
    out.add_(F.interpolate(low, size=tuple(x.shape[-2:]),
                           mode="nearest").permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


def conv_unbiased(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype):
    """(``layer``'s conv of x in ``dtype`` without its bias, the bias), for
    the caller to fold the bias into a pass it makes anyway: cuDNN's
    output plus a per-channel bias is a pass over the output of its own.
    An int8 site's output holds its bias: (that output, None)."""
    out = intercept(layer, x)
    if out is not None:
        return out, None
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride,
                    layer.padding), layer.bias


class GBlock(nn.Module):
    """DF-GAN's G_Block with its upsample: (B, in, H, W) -> (B, out, 2H,
    2W); with ``size``, GALIP's, whose nearest resize goes to (size, size)
    instead (the 2x path where that is 2H)."""

    def __init__(self, cond_dim: int, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32,
                 size: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.size = size
        self.learnable_sc = in_ch != out_ch
        self.c1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.c2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.fuse1 = DFBlock(cond_dim, in_ch)
        self.fuse2 = DFBlock(cond_dim, out_ch)
        if self.learnable_sc:
            self.c_sc = nn.Conv2d(in_ch, out_ch, 1, stride=1, padding=0)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """c1's bias goes into fuse2's first affine; c2's and c_sc's are
        added to the shortcut before its upsample (or resize)."""
        with span("attngan.gblock"):
            two_x = self.size is None or self.size == 2 * x.shape[-1]
            up = (dict(upsample=True) if two_x
                  else dict(size=(self.size, self.size)))
            h, bias = conv_unbiased(self.fuse1(x, cond, **up),
                                    self.c1, self.dtype)
            h, bias = conv_unbiased(self.fuse2(h, cond, shift=bias), self.c2,
                                    self.dtype)
            shortcut = x
            if self.learnable_sc:
                shortcut, sc_bias = conv_unbiased(x, self.c_sc, self.dtype)
                if sc_bias is not None:
                    bias = sc_bias if bias is None else bias + sc_bias
            if bias is not None:
                shortcut = shortcut + bias.to(shortcut.dtype).view(1, -1, 1, 1)
            return (add_upsampled if two_x else add_resized)(h, shortcut)


class DFGenerator(nn.Module):
    """forward(noise (B, z), sent_emb (B, emb), word_embs, mask, eps=None,
    generator=None) -> ([(B, 256, 256, 3) in [-1, 1]], [], None, None):
    models/generator.py's signature and outputs, one stage and no
    attention maps, mu or logvar."""

    has_attention = False
    unexportable = ("DF-GAN serves through its K7 kernel, which the "
                    "artifact cannot hold")

    def __init__(self, gf_dim: int = 32, emb_dim: int = 256,
                 z_dim: int = 100, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gf_dim = gf_dim
        self.fc = nn.Linear(z_dim, gf_dim * 8 * 4 * 4)
        self.GBlocks = nn.ModuleList(
            GBlock(z_dim + emb_dim, i, o, dtype)
            for i, o in channel_pairs(gf_dim))
        self.to_rgb = nn.Sequential(nn.LeakyReLU(SLOPE),
                                    nn.Conv2d(gf_dim, 3, 3, 1, 1), nn.Tanh())

    @classmethod
    def from_config(cls, cfg: GanConfig) -> "DFGenerator":
        return cls(cfg.gf_dim, cfg.emb_dim, cfg.z_dim,
                   compute_dtype(cfg.compute_dtype))

    def int8_sites(self) -> Dict[nn.Module, str]:
        """{layer: module name} of the int8 tier (infer/quantize.py; JAX
        has no DF-GAN): every Linear (``fc`` and the affines' MLPs) and
        conv."""
        return {m: name for name, m in self.named_modules()
                if isinstance(m, (nn.Linear, nn.Conv2d))}

    def forward(self, noise, sent_emb, word_embs=None, mask=None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        with span("attngan.generator"):
            noise = noise.float()
            cond = torch.cat([noise, sent_emb.float()], dim=1)
            h = intercept(self.fc, noise)
            if h is None:
                h = F.linear(noise.to(self.dtype), self.fc.weight.to(self.dtype),
                             self.fc.bias.to(self.dtype))
            # GAN.py views the features as NCHW
            x = h.to(self.dtype).view(-1, 8 * self.gf_dim, 4, 4).contiguous(
                memory_format=torch.channels_last)
            for block in self.GBlocks:
                x = block(x, cond)
            x = conv(F.leaky_relu(x, SLOPE), self.to_rgb[1], self.dtype)
            image = torch.tanh(x.float()).permute(0, 2, 3, 1)
        return [image], [], None, None
