"""3-stage attentional generator: port of attngan_tpu/models/generator.py.

  CondAugment: sent_emb -> Linear(4*cond) -> GLU -> (mu, logvar) -> the
    reparametrized condition code (fp32).
  InitialStage: concat(noise, cond) -> Linear(16*gf*4*4*2, no bias) -> BN ->
    GLU -> (B, 16*gf, 4, 4) -> 4x UpBlock -> (B, gf, 64, 64).
  NextStage: word attention -> concat(images, context) -> 2x ResBlock(2*gf)
    -> UpBlock(2*gf -> gf), doubling the resolution.
  MakeImage: conv3x3 -> tanh (fp32) -> RGB in [-1, 1].

Internally NCHW in channels_last memory; the public outputs keep the JAX
layouts: images (B, R, R, 3), attention maps (B, L, h, w). The
reparametrization noise ``eps`` can be passed in (JAX draws it with
jax.random, which no torch generator reproduces) or drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from attngan_torch.core.config import GanConfig
from attngan_torch.core.runtime import compute_dtype
from attngan_torch.ops.attention import word_attention
from attngan_torch.ops.cuda_attention import word_attention_cuda
from attngan_torch.ops.int8 import intercept
from attngan_torch.ops.layers import (
    BatchNorm,
    ResBlock,
    UpBlock,
    conv,
    conv3x3,
    glu,
)
from attngan_torch.utils.timing import span


class CondAugment(nn.Module):
    """Conditioning augmentation (JAX ``CondAugment``)."""

    def __init__(self, emb_dim: int, cond_dim: int = 100):
        super().__init__()
        self.cond_dim = cond_dim
        self.fc = nn.Linear(emb_dim, 4 * cond_dim)

    def forward(self, sent_emb: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        sent_emb = sent_emb.float()
        x = intercept(self.fc, sent_emb)
        x = glu(self.fc(sent_emb) if x is None else x, dim=-1)  # (B, 2*cond)
        mu, logvar = x[:, : self.cond_dim], x[:, self.cond_dim:]
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator,
                              device=std.device, dtype=std.dtype)
        return mu + eps.to(std) * std, mu, logvar


class InitialStage(nn.Module):
    """(noise, condition) -> (B, ng // 16, 64, 64), ng = 16 * gf."""

    def __init__(self, ng: int, in_features: int,
                 dtype: torch.dtype = torch.float32,
                 fused_upsample: bool = False):
        super().__init__()
        self.ng = ng
        self.dtype = dtype
        self.fused = fused_upsample     # its BN -> GLU as K8
        self.fc = nn.Linear(in_features, ng * 4 * 4 * 2, bias=False)
        self.bn = BatchNorm(ng * 4 * 4 * 2)
        self.up = nn.ModuleList(
            UpBlock(ng // (div // 2), ng // div, dtype, fused_upsample)
            for div in (2, 4, 8, 16))

    def forward(self, noise: torch.Tensor, condition: torch.Tensor):
        x = torch.cat([noise, condition], dim=-1)
        # an int8 site returns its fp32 input's type; JAX's BN (dtype=)
        # then computes in fp32 and casts to the compute dtype
        h = intercept(self.fc, x)
        if h is None:
            h = x.to(self.dtype) @ self.fc.weight.to(self.dtype).t()
        if h.dtype == self.dtype:
            x = self.bn.forward_glu(h, self.fused)
        else:
            x = glu(self.bn(h).to(self.dtype), dim=-1)
        # the JAX package reshapes the flat features as NHWC (-1, 4, 4, ng);
        # that (B, 4, 4, ng) tensor IS the channels_last NCHW layout
        x = x.view(-1, 4, 4, self.ng).permute(0, 3, 1, 2)
        for block in self.up:
            x = block(x)
        return x


class NextStage(nn.Module):
    """Word attention + residual merge + 2x upsample."""

    def __init__(self, gf_dim: int, emb_dim: int, num_residual: int = 2,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False,
                 fused_upsample: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_attention = fused_attention
        # the JAX conv1x1 over (B, 1, L, emb) words: a bias-free Linear
        self.word_proj = nn.Linear(emb_dim, gf_dim, bias=False)
        self.res = nn.ModuleList(ResBlock(2 * gf_dim, dtype, fused_upsample)
                                 for _ in range(num_residual))
        self.up = UpBlock(2 * gf_dim, gf_dim, dtype, fused_upsample)

    def forward(self, images: torch.Tensor, word_embs: torch.Tensor,
                mask: torch.Tensor):
        words = intercept(self.word_proj, word_embs)
        if words is None:
            words = (word_embs.to(self.dtype)
                     @ self.word_proj.weight.to(self.dtype).t())
        # an int8 site returns the fp32 words' type, which JAX's attention
        # promotes to; the port keeps the compute dtype, which K1 takes
        words = words.to(self.dtype)
        attend = word_attention_cuda if self.fused_attention else word_attention
        context, attn = attend(images.permute(0, 2, 3, 1).contiguous(),
                               words.contiguous(), mask)
        x = torch.cat([images, context.permute(0, 3, 1, 2)], dim=1)
        for block in self.res:
            x = block(x)
        return self.up(x), attn

    def int8_sites(self, prefix: str) -> Dict[nn.Module, str]:
        """The word projection (a 1x1 conv in JAX: the same per-output-
        channel scale) and the ResBlock convs, under JAX's paths."""
        return {self.word_proj: f"{prefix}/word_proj",
                **resblock_sites(self.res, prefix)}


def resblock_sites(blocks, prefix: str) -> Dict[nn.Module, str]:
    """{conv: JAX module path} of a stage's ResBlocks."""
    sites = {}
    for j, block in enumerate(blocks):
        sites[block.conv1] = f"{prefix}/ResBlock_{j}/Conv_0"
        sites[block.conv2] = f"{prefix}/ResBlock_{j}/Conv_1"
    return sites


class MakeImage(nn.Module):
    """Feature map -> RGB in [-1, 1], NHWC; tanh in fp32."""

    def __init__(self, gf_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv3x3(gf_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(conv(x, self.conv, self.dtype).float()).permute(
            0, 2, 3, 1)


class Generator(nn.Module):
    """forward(noise (B,z), sent_emb (B,emb), word_embs (B,L,emb), mask (B,L),
    eps=None, generator=None) -> ([per-stage (B,R,R,3)], [per-attention-stage
    (B,L,h,w)], mu, logvar). Train or eval BatchNorm follows ``.train()`` /
    ``.eval()``."""

    # word-attention maps to save (cli.infer --save-attention)
    has_attention = True
    # why infer/export.py cannot write this family (None: it can)
    unexportable = None
    # the module of stages 2..num_stages (models/dmgan.py: MemoryStage)
    next_stage = NextStage

    def __init__(self, gf_dim: int = 32, emb_dim: int = 256, z_dim: int = 100,
                 cond_dim: int = 100, num_stages: int = 3,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False,
                 fused_upsample: bool = False):
        super().__init__()
        self.ca = CondAugment(emb_dim, cond_dim)
        self.gen1 = InitialStage(16 * gf_dim, z_dim + cond_dim, dtype,
                                 fused_upsample)
        self.img_out1 = MakeImage(gf_dim, dtype)
        for stage in range(2, num_stages + 1):
            self.add_module(f"gen{stage}", self.next_stage(
                gf_dim, emb_dim, dtype=dtype, fused_attention=fused_attention,
                fused_upsample=fused_upsample))
            self.add_module(f"img_out{stage}", MakeImage(gf_dim, dtype))
        self.num_stages = num_stages

    @classmethod
    def from_config(cls, cfg: GanConfig) -> "Generator":
        return cls(cfg.gf_dim, cfg.emb_dim, cfg.z_dim, cfg.cond_dim,
                   cfg.num_stages, compute_dtype(cfg.compute_dtype),
                   cfg.fused_attention, cfg.fused_upsample)

    def int8_sites(self) -> Dict[nn.Module, str]:
        """{layer: JAX module path} of the int8 tier (infer/quantize.py):
        the CondAugment and InitialStage Dense, each next stage's sites
        (``NextStage.int8_sites``), each MakeImage conv. The UpBlocks'
        convs are no sites."""
        sites = {self.ca.fc: "CondAugment_0/Dense_0",
                 self.gen1.fc: "gen1/Dense_0"}
        for s in range(1, self.num_stages + 1):
            sites[getattr(self, f"img_out{s}").conv] = f"img_out{s}/Conv_0"
            if s > 1:
                sites.update(getattr(self, f"gen{s}").int8_sites(f"gen{s}"))
        return sites

    def forward(self, noise, sent_emb, word_embs, mask,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           torch.Tensor, torch.Tensor]:
        with span("attngan.generator"):
            condition, mu, logvar = self.ca(sent_emb, eps, generator)
            with span("attngan.stage1"):
                x = self.gen1(noise.float(), condition)
                fakes = [self.img_out1(x)]
            attns = []
            for stage in range(2, self.num_stages + 1):
                with span(f"attngan.stage{stage}"):
                    x, attn = getattr(self, f"gen{stage}")(x, word_embs, mask)
                    fakes.append(getattr(self, f"img_out{stage}")(x))
                attns.append(attn)
        return fakes, attns, mu, logvar
