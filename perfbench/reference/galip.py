"""GALIP's serving function, plain fp32: CLIP's text transformer and GALIP's
generator with its CLIP bridge.

Tao et al., "GALIP: Generative Adversarial CLIPs for Text-to-Image
Synthesis", CVPR 2023 (arXiv:2301.12959), as tobran/GALIP's
``code/models/GALIP.py`` computes it (``NetG``, ``CLIP_Adapter``,
``CLIP_Mapper``, ``M_Block``, ``G_Block``, ``DFBLK``, ``Affine``,
``CLIP_TXT_ENCODER``), and openai/CLIP's ``clip/model.py``
(``ResidualAttentionBlock``):

  text: x = token_embedding[tokens] + positional_embedding
        residual blocks: x += out_proj(MHA(ln_1(x))), then
          x += c_proj(QuickGELU(c_fc(ln_2(x)))); causal mask, heads of 64
        sentence = ln_final(x)[b, argmax(tokens[b])] @ text_projection
  cond = concat(noise, sentence)
  code = fc_code(noise).view(B, code_ch, code, code)
  bridge: prompts = fc_prompt(cond).view(B, 8, vit_width)
          M_Blocks: x = x + fuse2(conv2(fuse1(conv1(x))))
          fuse = conv_fuse(x); map = the ViT blocks on [class; pixels] +
            positional_embedding after ln_pre, a prompt concatenated
            before each of blocks 1..8 and sliced off after it
          out = conv(fuse + 0.1 map)
  G_Blocks: x = F.interpolate(x, size) (nearest), then
            x = shortcut(x) + c2(DF(c1(DF(x, cond)), cond))
  image = tanh(conv3x3(lrelu(x), 3)), returned (B, imsize, imsize, 3)

It imports nothing of the port (nor JAX) and runs no kernel. The
attention is written out as matmul, mask and softmax, each LayerNorm as
its mean and variance. Parameter names are the port's (GALIP.py's and
clip/model.py's). The bridge's sizes (code side and channels, the middle
channels, the M_Blocks, the prompt layers) come from the configuration.

Assumptions, none of which changes a shape: bf16 serving where the source
runs under autocast or in fp32 (this reference is fp32, TF32 off); random
weights in place of CLIP's and GALIP's trained ones; standard normal noise
(coco.yml samples with truncation 0.88); the tanh at the end of
``to_rgb``, as DF-GAN's ``NetG`` has it (GALIP.py leaves it commented
out); tokens in CLIP's layout (SOT 49406, the ids, EOT 49407, then 0),
pooled at the largest id; no ``conv1`` in the mapper, which GALIP.py
keeps from CLIP and never runs.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference import fp32
from perfbench.reference.dfgan import DFBLK, channel_pairs
from perfbench.reference.layers import Conv, Linear

SLOPE = 0.2
HEAD = 64
LN_EPS = 1e-5


class LayerNorm(nn.Module):
    """Over the last axis, in fp32: (x - mean) / sqrt(var + 1e-5) * weight +
    bias."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.weight + self.bias


class MHA(nn.Module):
    """nn.MultiheadAttention's parameters; its function written out."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, causal: bool):
        b, n, w = x.shape
        qkv = x @ self.in_proj_weight.t() + self.in_proj_bias
        q, k, v = (t.reshape(b, n, self.heads, HEAD).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        scores = q @ k.transpose(-1, -2) / math.sqrt(HEAD)
        if causal:
            scores = scores + torch.full((n, n), float("-inf"),
                                         device=x.device).triu(1)
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, n, w))


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))


class Block(nn.Module):
    """clip/model.py's ResidualAttentionBlock."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = MHA(width, heads)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNorm(width)

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(Block(width, heads)
                                       for _ in range(layers))


class CLIPText(nn.Module):
    """CLIP_TXT_ENCODER: tokens (B, context) -> the sentence (B, embed)."""

    def __init__(self, cfg: dict):
        super().__init__()
        w = cfg["clip_width"]
        self.token_embedding = nn.Embedding(cfg["vocab"], w)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg["seq_len"], w))
        self.transformer = Transformer(w, cfg["clip_layers"],
                                       cfg["clip_heads"])
        self.ln_final = LayerNorm(w)
        self.text_projection = nn.Parameter(torch.empty(w, cfg["emb_dim"]))

    def forward(self, tokens):
        x = self.token_embedding(tokens) + self.positional_embedding
        for block in self.transformer.resblocks:
            x = block(x, causal=True)
        x = self.ln_final(x)
        rows = torch.arange(x.shape[0], device=x.device)
        return x[rows, tokens.argmax(dim=-1)] @ self.text_projection


class MBlock(nn.Module):
    """M_Block with in == out: no shortcut conv."""

    def __init__(self, ch: int, mid: int, cond_dim: int):
        super().__init__()
        self.conv1 = Conv(ch, mid, 3, padding=1, bias=True)
        self.fuse1 = DFBLK(cond_dim, mid)
        self.conv2 = Conv(mid, ch, 3, padding=1, bias=True)
        self.fuse2 = DFBLK(cond_dim, ch)

    def forward(self, x, c):
        return x + self.fuse2(self.conv2(self.fuse1(self.conv1(x), c)), c)


class Mapper(nn.Module):
    """CLIP_Mapper: the ViT blocks on the bridge's pixels, with prompts."""

    def __init__(self, cfg: dict):
        super().__init__()
        w, g = cfg["vit_width"], cfg["code_size"]
        self.prompt_layers = list(cfg["prompt_layers"])
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(g * g + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, cfg["vit_layers"], cfg["vit_heads"])

    def forward(self, img, prompts):
        b, w, g = img.shape[:3]
        x = img.reshape(b, w, -1).permute(0, 2, 1)
        cls = self.class_embedding + torch.zeros(b, 1, w, device=x.device)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        k = 0
        for i, block in enumerate(self.transformer.resblocks):
            if i in self.prompt_layers:
                x = block(torch.cat([x, prompts[:, k:k + 1]], dim=1))[:, :-1]
                k += 1
            else:
                x = block(x)
        return x[:, 1:].permute(0, 2, 1).reshape(b, w, g, g)


class Bridge(nn.Module):
    """CLIP_Adapter: (code, cond) -> (B, 8 nf, code, code)."""

    def __init__(self, cfg: dict, cond_dim: int, g_ch: int):
        super().__init__()
        ch, w = cfg["code_ch"], cfg["vit_width"]
        self.vit_width = w
        self.FBlocks = nn.ModuleList(MBlock(ch, cfg["mid_ch"], cond_dim)
                                     for _ in range(cfg["map_num"]))
        self.conv_fuse = Conv(ch, w, 5, padding=2, bias=True)
        self.CLIP_ViT = Mapper(cfg)
        self.conv = Conv(w, g_ch, 5, padding=2, bias=True)
        self.fc_prompt = Linear(cond_dim, w * len(cfg["prompt_layers"]))

    def forward(self, x, c):
        prompts = self.fc_prompt(c).view(c.shape[0], -1, self.vit_width)
        for block in self.FBlocks:
            x = block(x, c)
        fuse = self.conv_fuse(x)
        return self.conv(fuse + 0.1 * self.CLIP_ViT(fuse, prompts))


class GBlock(nn.Module):
    """G_Block: the nearest resize to ``size``, then DF-GAN's block."""

    def __init__(self, cond_dim: int, cin: int, cout: int, size: int):
        super().__init__()
        self.size = size
        self.learnable_sc = cin != cout
        self.c1 = Conv(cin, cout, 3, padding=1, bias=True)
        self.c2 = Conv(cout, cout, 3, padding=1, bias=True)
        self.fuse1 = DFBLK(cond_dim, cin)
        self.fuse2 = DFBLK(cond_dim, cout)
        if self.learnable_sc:
            self.c_sc = Conv(cin, cout, 1, bias=True)

    def forward(self, x, y):
        x = F.interpolate(x, size=(self.size, self.size), mode="nearest")
        shortcut = self.c_sc(x) if self.learnable_sc else x
        return shortcut + self.c2(self.fuse2(self.c1(self.fuse1(x, y)), y))


def block_sizes(imsize: int, blocks: int) -> List[int]:
    """NetG's loop from 4: doubling, the last block to imsize."""
    return [4 * 2 ** (k + 1) for k in range(blocks - 1)] + [imsize]


class NetG(nn.Module):
    """(noise (B, z), sentence (B, emb)) -> images (B, imsize, imsize, 3)
    in [-1, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        nf, z, size = cfg["gf_dim"], cfg["z_dim"], cfg["imsize"]
        self.code = (cfg["code_ch"], cfg["code_size"])
        cond_dim = z + cfg["emb_dim"]
        pairs = channel_pairs(nf, size)
        self.fc_code = Linear(z, cfg["code_ch"] * cfg["code_size"] ** 2)
        self.mapping = Bridge(cfg, cond_dim, pairs[0][0])
        self.GBlocks = nn.ModuleList(
            GBlock(cond_dim, i, o, s) for (i, o), s in
            zip(pairs, block_sizes(size, len(pairs))))
        self.to_rgb = nn.Sequential(nn.LeakyReLU(SLOPE),
                                    Conv(nf, 3, 3, padding=1, bias=True),
                                    nn.Tanh())

    def forward(self, noise, sent):
        ch, g = self.code
        x = self.fc_code(noise).view(noise.shape[0], ch, g, g)
        cond = torch.cat([noise, sent], 1)
        x = self.mapping(x, cond)
        for block in self.GBlocks:
            x = block(x, cond)
        return self.to_rgb(x).permute(0, 2, 3, 1)


class Serving(nn.Module):
    """What a GALIP serving call computes, under the port's ``InferState``
    keys (``text_encoder.*``, ``generator.*``)."""

    def __init__(self, cfg: dict, vocab: int):
        super().__init__()
        self.text_encoder = CLIPText(dict(cfg, vocab=vocab))
        self.generator = NetG(cfg)

    def forward(self, tokens, lengths=None, noise=None, eps=None
                ) -> Tuple[List[torch.Tensor], list]:
        """([images (B, imsize, imsize, 3) in [0, 1]], []): one stage, no
        maps; ``lengths`` and ``eps`` are not read."""
        with fp32():
            image = self.generator(noise, self.text_encoder(tokens))
            return [torch.clamp(image * 0.5 + 0.5, 0.0, 1.0)], []
