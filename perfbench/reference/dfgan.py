"""DF-GAN's serving function, plain fp32: the text encoder and the
one-stage generator.

Tao et al., CVPR 2022 (arXiv:2008.05865), Sec. 3.2-3.3, as tobran/DF-GAN's
``code/models/GAN.py`` computes it (``NetG``, ``G_Block``, ``DFBLK``,
``Affine``):

  cond = concat(noise, sentence)                 (z + sentence width)
  x = fc(noise).view(B, 8 nf, 4, 4)
  six G_Blocks, 4^2 -> 256^2, channels nf * (8, 8, 8, 8, 4, 2, 1):
    x = upsample_nearest_2x(x)
    x = shortcut(x) + c2(DF(c1(DF(x, cond)), cond))
    shortcut: a 1x1 conv with bias where the channels change, else identity
  DF(x, cond) = lrelu(g1 * lrelu(g0 * x + b0) + b1), slope 0.2; each of
    g0, b0, g1, b1 its own MLP Linear(cond, C) -> ReLU -> Linear(C, C)
  image = tanh(conv3x3(lrelu(x), 3)), returned (B, 256, 256, 3)

The text encoder is the AttnGAN reference's (``generator.TextEncoder``),
DF-GAN's frozen DAMSM encoder. Parameter names are GAN.py's, which the
port keeps. No departure from GAN.py in the forward pass.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import fp32
from perfbench.reference.generator import TextEncoder
from perfbench.reference.layers import Conv, Linear

SLOPE = 0.2
IMSIZE = 256


def channel_pairs(nf: int, imsize: int = IMSIZE) -> List[Tuple[int, int]]:
    """GAN.py's ``get_G_in_out_chs``."""
    widths = [nf * min(2 ** k, 8) for k in range(int(math.log2(imsize)) - 1)]
    widths = widths[::-1]
    return list(zip(widths[:-1], widths[1:]))


class MLP(nn.Module):
    """Linear -> ReLU -> Linear, under GAN.py's ``linear1`` / ``linear2``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear1 = Linear(cin, cout)
        self.linear2 = Linear(cout, cout)

    def forward(self, y):
        return self.linear2(torch.relu(self.linear1(y)))


class Affine(nn.Module):
    def __init__(self, cond_dim: int, features: int):
        super().__init__()
        self.fc_gamma = MLP(cond_dim, features)
        self.fc_beta = MLP(cond_dim, features)

    def forward(self, x, y):
        gamma = self.fc_gamma(y)[:, :, None, None].expand(x.shape)
        beta = self.fc_beta(y)[:, :, None, None].expand(x.shape)
        return gamma * x + beta


class DFBLK(nn.Module):
    def __init__(self, cond_dim: int, features: int):
        super().__init__()
        self.affine0 = Affine(cond_dim, features)
        self.affine1 = Affine(cond_dim, features)

    def forward(self, x, y):
        h = F.leaky_relu(self.affine0(x, y), SLOPE)
        return F.leaky_relu(self.affine1(h, y), SLOPE)


class G_Block(nn.Module):
    def __init__(self, cond_dim: int, cin: int, cout: int):
        super().__init__()
        self.learnable_sc = cin != cout
        self.c1 = Conv(cin, cout, 3, padding=1, bias=True)
        self.c2 = Conv(cout, cout, 3, padding=1, bias=True)
        self.fuse1 = DFBLK(cond_dim, cin)
        self.fuse2 = DFBLK(cond_dim, cout)
        if self.learnable_sc:
            self.c_sc = Conv(cin, cout, 1, bias=True)

    def forward(self, x, y):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        shortcut = self.c_sc(x) if self.learnable_sc else x
        return shortcut + self.c2(self.fuse2(self.c1(self.fuse1(x, y)), y))


class NetG(nn.Module):
    """(noise (B, z), sentence (B, S)) -> images (B, 256, 256, 3) in [-1, 1]."""

    def __init__(self, nf: int, z_dim: int, sent_dim: int):
        super().__init__()
        self.nf = nf
        self.fc = Linear(z_dim, nf * 8 * 4 * 4)
        self.GBlocks = nn.ModuleList(G_Block(z_dim + sent_dim, i, o)
                                     for i, o in channel_pairs(nf))
        self.to_rgb = nn.Sequential(nn.LeakyReLU(SLOPE),
                                    Conv(nf, 3, 3, padding=1, bias=True),
                                    nn.Tanh())

    def forward(self, noise, sent):
        x = self.fc(noise).view(noise.shape[0], 8 * self.nf, 4, 4)
        cond = torch.cat([noise, sent], 1)
        for block in self.GBlocks:
            x = block(x, cond)
        return self.to_rgb(x).permute(0, 2, 3, 1)


class Serving(nn.Module):
    """What a DF-GAN serving call computes, under the port's ``InferState``
    keys (``rnn.*``, ``generator.*``)."""

    def __init__(self, cfg: dict, vocab: int):
        super().__init__()
        self.rnn = TextEncoder(vocab, cfg["text_emb_dim"], cfg["emb_dim"])
        self.generator = NetG(cfg["gf_dim"], cfg["z_dim"], cfg["emb_dim"])

    def forward(self, tokens, lengths, noise, eps=None):
        """([images (B, 256, 256, 3) in [0, 1]], []): one stage, no
        attention maps; ``eps`` is not read."""
        with fp32():
            _, sent = self.rnn(tokens, lengths)
            image = self.generator(noise, sent)
            return [torch.clamp(image * 0.5 + 0.5, 0.0, 1.0)], []
