"""DM-GAN's generator: AttnGAN's cascade with each next stage's word
attention replaced by a dynamic memory.

Zhu, Pan, Chen and Yang, "DM-GAN: Dynamic Memory Generative Adversarial
Networks for Text-to-Image Synthesis", CVPR 2019 (arXiv:1904.01310), Sec.
3; the layers of MinfengZhu/DM-GAN's ``code/model.py`` (``G_NET``,
``NEXT_STAGE_G``, ``Memory``). Stage 1 is AttnGAN's (models/generator.py:
CondAugment, InitialStage, MakeImage); each next stage, on R (B, gf, H,
W), the word features W (B, L, emb) and the mask:

  memory write    r = mean of R over H x W                     (B, gf)
                  g_w = sigmoid(A w_i + B r)                   A, B: no bias
                  m_i = relu(M_w w_i) g_w + relu(M_r r) (1 - g_w)   (2 gf)
  addressing      k_i = relu(key m_i), v_i = relu(value m_i)   (gf)
                  attn = softmax over the real words of R_j . k_i (unscaled)
                  o_j = sum_i attn_ij v_i
  response gate   g_r = sigmoid(response_gate [R_j; o_j])
                  R'_j = o_j g_r + R_j (1 - g_r)
  then            [R'; R'] (2 gf) -> 2 ResBlocks -> UpBlock(2 gf -> gf)

``model.py``'s 1x1 Conv1d layers (M_w, M_r, key, value) and the gate's
1x1 Conv2d are Linears over the last axis here, with the same weights
squeezed; A, B and the memory layers keep ``model.py``'s names. The
memory write runs in fp32 as small products; the read and the gate are
one launch of K1's memory form (ops/cuda_attention.py::memory_read_cuda)
where ``fused_attention`` is on, its plain version (ops/attention.py::
memory_read) elsewhere. Each caption's own mask is applied: ``Memory``
repeats the batch's masks over the pixels (``mask.repeat(queryL, 1)``),
which gives a row of a batch > 1 another row's mask.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.models.generator import Generator, resblock_sites
from attngan_torch.ops.attention import memory_read
from attngan_torch.ops.cuda_attention import memory_read_cuda
from attngan_torch.ops.int8 import linear
from attngan_torch.ops.layers import ResBlock, UpBlock
from attngan_torch.utils.timing import span


class MemoryStage(nn.Module):
    """DM-GAN's NEXT_STAGE_G: memory write, key-value read, response gate,
    then AttnGAN's ResBlocks and UpBlock. forward(images (B, gf, H, W),
    word_embs (B, L, emb), mask (B, L)) -> ((B, gf, 2H, 2W), attn (B, L,
    H, W) fp32)."""

    def __init__(self, gf_dim: int, emb_dim: int, num_residual: int = 2,
                 dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False,
                 fused_upsample: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused_attention = fused_attention
        self.A = nn.Linear(emb_dim, 1, bias=False)
        self.B = nn.Linear(gf_dim, 1, bias=False)
        self.M_w = nn.Linear(emb_dim, 2 * gf_dim)
        self.M_r = nn.Linear(gf_dim, 2 * gf_dim)
        self.key = nn.Linear(2 * gf_dim, gf_dim)
        self.value = nn.Linear(2 * gf_dim, gf_dim)
        self.response_gate = nn.Linear(2 * gf_dim, 1)
        self.res = nn.ModuleList(ResBlock(2 * gf_dim, dtype, fused_upsample)
                                 for _ in range(num_residual))
        self.up = UpBlock(2 * gf_dim, gf_dim, dtype, fused_upsample)

    def forward(self, images: torch.Tensor, word_embs: torch.Tensor,
                mask: torch.Tensor):
        with span("attngan.memory"):
            words = word_embs.float()
            pooled = images.mean((2, 3), dtype=torch.float32)     # (B, gf)
            write = torch.sigmoid(linear(self.A, words)
                                  + linear(self.B, pooled)[:, None])
            memory = (F.relu(linear(self.M_w, words)) * write
                      + F.relu(linear(self.M_r, pooled))[:, None]
                      * (1.0 - write))
            key = F.relu(linear(self.key, memory)).to(self.dtype)
            value = F.relu(linear(self.value, memory)).to(self.dtype)
            read = memory_read_cuda if self.fused_attention else memory_read
            x, attn = read(images.permute(0, 2, 3, 1).contiguous(),
                           key.contiguous(), value.contiguous(), mask,
                           self.response_gate.weight.view(-1),
                           self.response_gate.bias)
            x = x.permute(0, 3, 1, 2)
        for block in self.res:
            x = block(x)
        return self.up(x), attn

    def int8_sites(self, prefix: str) -> Dict[nn.Module, str]:
        """The memory write's Linears and the ResBlock convs. The response
        gate runs inside the memory read, in float."""
        sites = {getattr(self, name): f"{prefix}/{name}" for name in
                 ("A", "B", "M_w", "M_r", "key", "value")}
        return {**sites, **resblock_sites(self.res, prefix)}


class DMGenerator(Generator):
    """forward(noise (B, z), sent_emb (B, emb), word_embs (B, L, emb), mask
    (B, L), eps=None, generator=None) -> ([per-stage (B, R, R, 3)], [per
    memory stage (B, L, h, w)], mu, logvar): models/generator.py's
    signature, outputs and stage 1, with MemoryStage as the next stages."""

    next_stage = MemoryStage
    unexportable = ("DM-GAN is served by the live sampler only: "
                    "infer/export.py's artifact has not been held against "
                    "DM-GAN's reference")
