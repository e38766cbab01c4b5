"""DF-GAN's generator as a plain fp32 PyTorch reference for the tests.

Written from Tao et al., "DF-GAN: A Simple and Effective Baseline for
Text-to-Image Synthesis" (CVPR 2022, arXiv:2008.05865), Sec. 3.2-3.3, and
tobran/DF-GAN's ``code/models/GAN.py`` (``NetG``, ``G_Block``, ``DFBLK``,
``Affine``), step for step as that file computes it: upsample, then the
shortcut and the residual on the upsampled map, each affine as
``gamma * x + beta`` broadcast over the pixels. Products run in true fp32:
``forward`` turns TF32 off for its call and restores the flags after.

It imports nothing of the port (nor JAX) and runs no kernel. Its modules
carry GAN.py's parameter names, which the port keeps, so that one state
dict loads strictly into both.

Departures from GAN.py, none in the forward pass:
- ``forward`` returns the image as (B, 256, 256, 3), the port's layout
  (GAN.py: (B, 3, 256, 256)).
- ``Affine`` leaves its weights to the caller; GAN.py initialises each
  gamma MLP's last layer to give 1 and each beta MLP's to give 0, a
  training start that the tests' seeded weights replace.
"""

import contextlib
import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

SLOPE = 0.2
IMSIZE = 256


@contextlib.contextmanager
def fp32():
    """True fp32 products (TF32 off) inside, the flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def get_G_in_out_chs(nf, imsize=IMSIZE):
    layer_num = int(math.log2(imsize)) - 1
    channel_nums = [nf * min(2 ** idx, 8) for idx in range(layer_num)]
    channel_nums = channel_nums[::-1]
    return list(zip(channel_nums[:-1], channel_nums[1:]))


class Affine(nn.Module):
    def __init__(self, cond_dim, num_features):
        super().__init__()
        self.fc_gamma = nn.Sequential(OrderedDict([
            ("linear1", nn.Linear(cond_dim, num_features)),
            ("relu1", nn.ReLU()),
            ("linear2", nn.Linear(num_features, num_features))]))
        self.fc_beta = nn.Sequential(OrderedDict([
            ("linear1", nn.Linear(cond_dim, num_features)),
            ("relu1", nn.ReLU()),
            ("linear2", nn.Linear(num_features, num_features))]))

    def forward(self, x, y):
        weight = self.fc_gamma(y)
        bias = self.fc_beta(y)
        size = x.size()
        weight = weight.unsqueeze(-1).unsqueeze(-1).expand(size)
        bias = bias.unsqueeze(-1).unsqueeze(-1).expand(size)
        return weight * x + bias


class DFBLK(nn.Module):
    def __init__(self, cond_dim, in_ch):
        super().__init__()
        self.affine0 = Affine(cond_dim, in_ch)
        self.affine1 = Affine(cond_dim, in_ch)

    def forward(self, x, y):
        h = F.leaky_relu(self.affine0(x, y), SLOPE)
        return F.leaky_relu(self.affine1(h, y), SLOPE)


class G_Block(nn.Module):
    def __init__(self, cond_dim, in_ch, out_ch):
        super().__init__()
        self.learnable_sc = in_ch != out_ch
        self.c1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.c2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.fuse1 = DFBLK(cond_dim, in_ch)
        self.fuse2 = DFBLK(cond_dim, out_ch)
        if self.learnable_sc:
            self.c_sc = nn.Conv2d(in_ch, out_ch, 1, stride=1, padding=0)

    def shortcut(self, x):
        return self.c_sc(x) if self.learnable_sc else x

    def residual(self, h, y):
        h = self.c1(self.fuse1(h, y))
        return self.c2(self.fuse2(h, y))

    def forward(self, x, y):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.shortcut(x) + self.residual(x, y)


class NetG(nn.Module):
    """(noise (B, nz), sentence embedding (B, cond_dim)) -> images (B, 256,
    256, 3) in [-1, 1]."""

    def __init__(self, ngf=32, nz=100, cond_dim=256, imsize=IMSIZE,
                 ch_size=3):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Linear(nz, ngf * 8 * 4 * 4)
        self.GBlocks = nn.ModuleList(
            G_Block(cond_dim + nz, i, o)
            for i, o in get_G_in_out_chs(ngf, imsize))
        self.to_rgb = nn.Sequential(nn.LeakyReLU(SLOPE),
                                    nn.Conv2d(ngf, ch_size, 3, 1, 1),
                                    nn.Tanh())

    def forward(self, noise, c):
        with fp32():
            out = self.fc(noise).view(noise.size(0), 8 * self.ngf, 4, 4)
            cond = torch.cat((noise, c), dim=1)
            for block in self.GBlocks:
                out = block(out, cond)
            return self.to_rgb(out).permute(0, 2, 3, 1)
