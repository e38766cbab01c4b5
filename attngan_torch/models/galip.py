"""GALIP's generator: DF-GAN's G_Blocks behind a bridge that runs CLIP's
visual transformer on the generator's own features.

Tao, Bao, Ding, Wang and Wu, "GALIP: Generative Adversarial CLIPs for
Text-to-Image Synthesis", CVPR 2023 (arXiv:2301.12959); the layers of
tobran/GALIP's ``code/models/GALIP.py`` (``NetG``, ``CLIP_Adapter``,
``CLIP_Mapper``, ``M_Block``, ``G_Block``, ``DFBLK``, ``Affine``), with its
parameter names, so that its generator's state dict loads as it is (but
for ``CLIP_ViT.conv1``, the patch conv the mapper never runs):

  cond = concat(noise, sentence)                (z_dim + emb_dim)
  code = fc_code(noise).view(B, 64, 7, 7)
  the bridge (``mapping``, CLIP_Adapter):
    prompts = fc_prompt(cond).view(B, 8, vit_width)
    4 M_Blocks at 7^2: x = x + fuse2(conv2(fuse1(conv1(x))))
      (3x3 convs 64 -> 32 -> 64, DF layers at 32 and 64 channels)
    fuse = conv_fuse(x)                          5x5, 64 -> vit_width
    map = CLIP_ViT(fuse, prompts): the 49 pixels as tokens after the class
      token, + positional_embedding, ln_pre, the ViT's residual blocks
      (no mask), block i in 1..8 with prompts[:, i - 1] as a 51st token
      dropped after it; tokens 1..49 back as (B, vit_width, 7, 7)
    out = conv(fuse + 0.1 map)                   5x5, vit_width -> 8 nf
  five G_Blocks to 8, 16, 32, 64 and imsize: x = nearest_resize(x), then
    x = shortcut(x) + c2(DF(c1(DF(x; cond)); cond))  (models/dfgan.py)
  image = tanh(conv3x3(lrelu(x), 3))

How the port computes it: the bridge's residual stream, ln_pre and the
ViT blocks as models/clip.py computes the text tower's (unmasked, K11 at
50 and 51 tokens); the prompt token is written into a spare 51st row of
one (B, 51, vit_width) buffer in place of GALIP's concat and slice, and
the blocks without a prompt run on the buffer's first 50 rows. The
M_Blocks' convs fold their biases into the next DF layer's shift; the
G_Blocks are DF-GAN's, their DF layers through K7's 2x form where the
resize is 2x and its resize form at 7 -> 8 and 64 -> imsize, the
shortcut added after a nearest resize of its own. The word embeddings,
the mask and eps that ``forward`` takes (the serving path's one
signature) are not read.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.core.config import GanConfig
from attngan_torch.core.runtime import compute_dtype
from attngan_torch.models.clip import Transformer, layer_norm, linear_in
from attngan_torch.models.dfgan import (
    DFBlock,
    GBlock,
    channel_pairs,
    conv_unbiased,
)
from attngan_torch.ops.cuda_dfblock import SLOPE
from attngan_torch.ops.int8 import linear
from attngan_torch.ops.layers import conv
from attngan_torch.utils.timing import span

CODE_SIZE, CODE_CH, MID_CH = 7, 64, 32   # NetG's code_sz, code_ch, mid_ch
MAP_NUM = 4                              # M_Blocks in the bridge
PROMPT_LAYERS = range(1, 9)              # CLIP_Mapper's ``selected``
VIT_LAYERS = 12                          # ViT-B/32's residual blocks
IMSIZE = 224                             # coco.yml's imsize


def block_sizes(imsize: int, blocks: int) -> List[int]:
    """Each G_Block's output side: 8, 16, ... doubling, then ``imsize``
    (NetG's loop from 4)."""
    return [4 * 2 ** (k + 1) for k in range(blocks - 1)] + [imsize]


class MBlock(nn.Module):
    """GALIP's M_Block, in == out: x + fuse2(conv2(fuse1(conv1(x))))."""

    def __init__(self, channels: int, mid: int, cond_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, mid, 3, 1, 1)
        self.fuse1 = DFBlock(cond_dim, mid)
        self.conv2 = nn.Conv2d(mid, channels, 3, 1, 1)
        self.fuse2 = DFBlock(cond_dim, channels)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h, bias = conv_unbiased(x, self.conv1, self.dtype)
        h, bias = conv_unbiased(self.fuse1(h, cond, shift=bias), self.conv2,
                                self.dtype)
        return x + self.fuse2(h, cond, shift=bias)


class CLIPMapper(nn.Module):
    """GALIP's CLIP_Mapper: CLIP's visual tower from its class token on,
    without its patch conv, ``ln_post`` or ``proj``. forward(fuse (B, W,
    g, g), prompts (B, 8, W)) -> (B, W, g, g) fp32."""

    def __init__(self, width: int = 768, heads: int = 12,
                 grid: int = CODE_SIZE, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.class_embedding = nn.Parameter(width ** -0.5
                                            * torch.randn(width))
        self.positional_embedding = nn.Parameter(
            width ** -0.5 * torch.randn(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, VIT_LAYERS, heads, dtype)

    def forward(self, fuse: torch.Tensor, prompts: torch.Tensor
                ) -> torch.Tensor:
        b, w, g = fuse.shape[:3]
        n = g * g + 1
        pixels = fuse.permute(0, 2, 3, 1).reshape(b, g * g, w)
        tokens = torch.cat([self.class_embedding.expand(b, 1, w),
                            pixels.float()], dim=1) + self.positional_embedding
        # one buffer of n + 1 rows: the last is the prompt's
        x = torch.empty((b, n + 1, w), dtype=torch.float32,
                        device=fuse.device)
        x[:, :n] = layer_norm(tokens, self.ln_pre)
        for i, block in enumerate(self.transformer.resblocks):
            if i in PROMPT_LAYERS:
                x[:, n] = prompts[:, PROMPT_LAYERS.index(i)]
                block(x)
            else:
                block(x[:, :n])
        return x[:, 1:n].reshape(b, g, g, w).permute(0, 3, 1, 2)


class CLIPBridge(nn.Module):
    """GALIP's CLIP_Adapter: forward(code (B, 64, 7, 7), cond) -> (B, G_ch,
    7, 7) in the compute dtype."""

    def __init__(self, cond_dim: int, g_ch: int, vit_width: int = 768,
                 vit_heads: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vit_width = vit_width
        self.FBlocks = nn.ModuleList(MBlock(CODE_CH, MID_CH, cond_dim, dtype)
                                     for _ in range(MAP_NUM))
        self.conv_fuse = nn.Conv2d(CODE_CH, vit_width, 5, 1, 2)
        self.CLIP_ViT = CLIPMapper(vit_width, vit_heads, CODE_SIZE, dtype)
        self.conv = nn.Conv2d(vit_width, g_ch, 5, 1, 2)
        self.fc_prompt = nn.Linear(cond_dim, vit_width * len(PROMPT_LAYERS))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        prompts = linear(self.fc_prompt, cond).float().view(
            cond.shape[0], -1, self.vit_width)
        for block in self.FBlocks:
            x = block(x, cond)
        fuse = conv(x, self.conv_fuse, self.dtype)
        mapped = self.CLIP_ViT(fuse, prompts)
        return conv(torch.add(fuse, mapped, alpha=0.1), self.conv, self.dtype)


class GALIPGenerator(nn.Module):
    """forward(noise (B, z), sent_emb (B, emb), word_embs, mask, eps=None,
    generator=None) -> ([(B, imsize, imsize, 3) in [-1, 1]], [], None,
    None): models/generator.py's signature and outputs, one stage and no
    attention maps, mu or logvar."""

    has_attention = False
    unexportable = ("GALIP serves through its K7 and K11 kernels, which the "
                    "artifact cannot hold")

    def __init__(self, gf_dim: int = 64, emb_dim: int = 512,
                 z_dim: int = 100, vit_width: int = 768,
                 vit_heads: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cond_dim = z_dim + emb_dim
        pairs = channel_pairs(gf_dim, IMSIZE)
        self.fc_code = nn.Linear(z_dim, CODE_SIZE * CODE_SIZE * CODE_CH)
        self.mapping = CLIPBridge(cond_dim, pairs[0][0], vit_width,
                                  vit_heads, dtype)
        self.GBlocks = nn.ModuleList(
            GBlock(cond_dim, i, o, dtype, size) for (i, o), size in
            zip(pairs, block_sizes(IMSIZE, len(pairs))))
        self.to_rgb = nn.Sequential(nn.LeakyReLU(SLOPE),
                                    nn.Conv2d(gf_dim, 3, 3, 1, 1), nn.Tanh())

    @classmethod
    def from_config(cls, cfg: GanConfig) -> "GALIPGenerator":
        return cls(cfg.gf_dim, cfg.emb_dim, cfg.z_dim, cfg.vit_width,
                   cfg.vit_heads, compute_dtype(cfg.compute_dtype))

    def int8_sites(self) -> Dict[nn.Module, str]:
        """{layer: module name} of the int8 tier (infer/quantize.py; JAX
        has no GALIP): every Linear (``fc_code``, ``fc_prompt``, the
        affines' MLPs, the ViT blocks' out_proj, c_fc and c_proj) and
        conv. The ViT blocks' packed in_proj is a raw parameter, as
        nn.MultiheadAttention keeps it, and stays in the float path."""
        return {m: name for name, m in self.named_modules()
                if isinstance(m, (nn.Linear, nn.Conv2d))}

    def forward(self, noise, sent_emb, word_embs=None, mask=None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        with span("attngan.generator"):
            noise = noise.float()
            cond = torch.cat([noise, sent_emb.float()], dim=1)
            h = linear_in(self.fc_code, noise, self.dtype)
            # GALIP.py views the code as NCHW
            x = h.to(self.dtype).view(-1, CODE_CH, CODE_SIZE,
                                      CODE_SIZE).contiguous(
                memory_format=torch.channels_last)
            with span("attngan.clip_bridge"):
                x = self.mapping(x, cond)
            for block in self.GBlocks:
                x = block(x, cond)
            x = conv(F.leaky_relu(x, SLOPE), self.to_rgb[1], self.dtype)
            image = torch.tanh(x.float()).permute(0, 2, 3, 1)
        return [image], [], None, None
