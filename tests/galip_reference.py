"""GALIP's serving forward as a plain fp32 PyTorch reference for the tests:
CLIP's text transformer and GALIP's generator.

Written from Tao et al., "GALIP: Generative Adversarial CLIPs for
Text-to-Image Synthesis" (CVPR 2023, arXiv:2301.12959), tobran/GALIP's
``code/models/GALIP.py`` (``NetG``, ``CLIP_Adapter``, ``CLIP_Mapper``,
``M_Block``, ``G_Block``, ``DFBLK``, ``Affine``, ``CLIP_TXT_ENCODER``) and
openai/CLIP's ``clip/model.py`` (``ResidualAttentionBlock``), step for
step as those files compute it: the attention written out as matmul, mask
and softmax; each resize by ``F.interpolate(mode="nearest")``; each prompt
token concatenated before its block and sliced off after it; each affine
as ``gamma * x + beta`` broadcast over the pixels. Products run in true
fp32: ``forward`` turns TF32 off for its call and restores the flags
after.

It imports nothing of the port (nor JAX) and runs no kernel. Its modules
carry the port's parameter names (GALIP.py's and clip/model.py's), so
that one state dict loads strictly into both.

Assumptions, none of which changes a shape:
- The image is ``tanh(conv(lrelu(x)))``: DF-GAN's ``NetG`` ends in a tanh,
  which GALIP.py's ``to_rgb`` leaves commented out; ``forward`` returns it
  as (B, imsize, imsize, 3), the port's layout.
- The text tower takes tokens in CLIP's layout (SOT, ids, EOT, then 0)
  and pools at the largest id, the EOT; it returns the sentence only,
  which is all that ``NetG`` reads.
- CLIP's attention scales the scores by 1/sqrt(64) and masks the text's
  keys after each query with -inf; the ViT blocks run unmasked.
- Weights are the caller's (random in the tests), in fp32; GALIP serves
  CLIP's trained fp16 weights under autocast.
- The mapper has no ``conv1``: GALIP.py keeps CLIP's patch conv in the
  mapper and never runs it.
"""

import contextlib
import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

SLOPE = 0.2
HEAD = 64
PROMPT_LAYERS = [1, 2, 3, 4, 5, 6, 7, 8]      # CLIP_Mapper's ``selected``


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


def get_G_in_out_chs(nf, imsize):
    layer_num = int(math.log2(imsize)) - 1
    channel_nums = [nf * min(2 ** idx, 8) for idx in range(layer_num)]
    channel_nums = channel_nums[::-1]
    return list(zip(channel_nums[:-1], channel_nums[1:]))


# ---- CLIP ----

class MHA(nn.Module):
    """nn.MultiheadAttention's parameters, its function written out."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal):
        b, n, w = x.shape
        q, k, v = (x @ self.in_proj_weight.t()
                   + self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, HEAD).transpose(1, 2)
                   for t in (q, k, v))
        scores = q @ k.transpose(-1, -2) / math.sqrt(HEAD)
        if causal:
            mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
            scores = scores + mask
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, n, w))


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.attn = MHA(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width))]))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x, causal=False):
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))


class TextTower(nn.Module):
    """CLIP_TXT_ENCODER: tokens (B, context) -> sentence (B, embed)."""

    def __init__(self, vocab, context, width, heads, layers, embed):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(torch.empty(context, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed))

    def forward(self, tokens, causal=True):
        with fp32():
            x = self.token_embedding(tokens) + self.positional_embedding
            for block in self.transformer.resblocks:
                x = block(x, causal)
            x = self.ln_final(x)
            rows = torch.arange(x.shape[0], device=x.device)
            return x[rows, tokens.argmax(dim=-1)] @ self.text_projection


# ---- GALIP ----

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
        weight = self.fc_gamma(y)[:, :, None, None].expand(x.size())
        bias = self.fc_beta(y)[:, :, None, None].expand(x.size())
        return weight * x + bias


class DFBLK(nn.Module):
    def __init__(self, cond_dim, in_ch):
        super().__init__()
        self.affine0 = Affine(cond_dim, in_ch)
        self.affine1 = Affine(cond_dim, in_ch)

    def forward(self, x, y):
        h = F.leaky_relu(self.affine0(x, y), SLOPE)
        return F.leaky_relu(self.affine1(h, y), SLOPE)


class M_Block(nn.Module):
    """in == out (GALIP's bridge): no shortcut conv."""

    def __init__(self, in_ch, mid_ch, out_ch, cond_dim, k, s, p):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid_ch, k, s, p)
        self.fuse1 = DFBLK(cond_dim, mid_ch)
        self.conv2 = nn.Conv2d(mid_ch, out_ch, k, s, p)
        self.fuse2 = DFBLK(cond_dim, out_ch)

    def forward(self, h, c):
        r = self.fuse1(self.conv1(h), c)
        return h + self.fuse2(self.conv2(r), c)


class CLIP_Mapper(nn.Module):
    def __init__(self, width, heads, layers, grid):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, layers, heads)

    def forward(self, img, prompts, use_prompts=True):
        b, w, grid = img.shape[:3]
        x = img.reshape(b, w, -1).permute(0, 2, 1)
        x = torch.cat([self.class_embedding + torch.zeros(b, 1, w,
                                                          device=x.device),
                       x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        prompt_idx = 0
        for i, block in enumerate(self.transformer.resblocks):
            if i in PROMPT_LAYERS and use_prompts:
                prompt = prompts[:, prompt_idx, :].unsqueeze(1)
                prompt_idx += 1
                x = block(torch.cat((x, prompt), dim=1))[:, :-1]
            else:
                x = block(x)
        return x[:, 1:, :].permute(0, 2, 1).reshape(b, w, grid, grid)


class CLIP_Adapter(nn.Module):
    def __init__(self, in_ch, mid_ch, out_ch, G_ch, CLIP_ch, cond_dim, k, s,
                 p, map_num, heads, layers, grid):
        super().__init__()
        self.CLIP_ch = CLIP_ch
        self.FBlocks = nn.ModuleList(
            [M_Block(in_ch, mid_ch, out_ch, cond_dim, k, s, p)]
            + [M_Block(out_ch, mid_ch, out_ch, cond_dim, k, s, p)
               for _ in range(map_num - 1)])
        self.conv_fuse = nn.Conv2d(out_ch, CLIP_ch, 5, 1, 2)
        self.CLIP_ViT = CLIP_Mapper(CLIP_ch, heads, layers, grid)
        self.conv = nn.Conv2d(CLIP_ch, G_ch, 5, 1, 2)
        self.fc_prompt = nn.Linear(cond_dim, CLIP_ch * 8)

    def forward(self, out, c, faults=()):
        prompts = self.fc_prompt(c).view(c.size(0), -1, self.CLIP_ch)
        for FBlock in self.FBlocks:
            out = FBlock(out, c)
        fuse_feat = self.conv_fuse(out)
        map_feat = self.CLIP_ViT(fuse_feat, prompts,
                                 "no_prompts" not in faults)
        if "no_bridge" in faults:
            map_feat = torch.zeros_like(map_feat)
        return self.conv(fuse_feat + 0.1 * map_feat), map_feat


class G_Block(nn.Module):
    def __init__(self, cond_dim, in_ch, out_ch, imsize):
        super().__init__()
        self.imsize = imsize
        self.learnable_sc = in_ch != out_ch
        self.c1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.c2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.fuse1 = DFBLK(cond_dim, in_ch)
        self.fuse2 = DFBLK(cond_dim, out_ch)
        if self.learnable_sc:
            self.c_sc = nn.Conv2d(in_ch, out_ch, 1, stride=1, padding=0)

    def forward(self, h, y):
        h = F.interpolate(h, size=(self.imsize, self.imsize), mode="nearest")
        shortcut = self.c_sc(h) if self.learnable_sc else h
        r = self.c1(self.fuse1(h, y))
        return shortcut + self.c2(self.fuse2(r, y))


class NetG(nn.Module):
    """(noise (B, nz), sentence (B, cond_dim)) -> (images (B, imsize,
    imsize, 3) in [-1, 1], the mapper's output (B, CLIP_ch, 7, 7))."""

    def __init__(self, ngf=64, nz=100, cond_dim=512, imsize=224,
                 clip_ch=768, heads=12, layers=12):
        super().__init__()
        self.code_sz, self.code_ch, self.mid_ch = 7, 64, 32
        self.fc_code = nn.Linear(nz, self.code_sz * self.code_sz
                                 * self.code_ch)
        self.mapping = CLIP_Adapter(self.code_ch, self.mid_ch, self.code_ch,
                                    ngf * 8, clip_ch, cond_dim + nz, 3, 1, 1,
                                    4, heads, layers, self.code_sz)
        self.GBlocks = nn.ModuleList()
        size = 4
        pairs = get_G_in_out_chs(ngf, imsize)
        for idx, (in_ch, out_ch) in enumerate(pairs):
            size = size * 2 if idx < len(pairs) - 1 else imsize
            self.GBlocks.append(G_Block(cond_dim + nz, in_ch, out_ch, size))
        self.to_rgb = nn.Sequential(nn.LeakyReLU(SLOPE),
                                    nn.Conv2d(out_ch, 3, 3, 1, 1), nn.Tanh())

    def forward(self, noise, c, faults=()):
        with fp32():
            cond = torch.cat((noise, c), dim=1)
            code = self.fc_code(noise).view(noise.size(0), self.code_ch,
                                            self.code_sz, self.code_sz)
            out, map_feat = self.mapping(code, cond, faults)
            for block in self.GBlocks:
                out = block(out, cond)
            return self.to_rgb(out).permute(0, 2, 3, 1), map_feat
