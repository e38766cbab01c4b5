"""DM-GAN's serving function, plain fp32: the text encoder and the 3-stage
generator with dynamic-memory refinement stages.

Zhu et al., CVPR 2019 (arXiv:1904.01310), Sec. 3, as MinfengZhu/DM-GAN's
``code/model.py`` computes it (``G_NET``, ``NEXT_STAGE_G``, ``Memory``).
Stage 1, the images and the text encoder are the AttnGAN reference's
(``generator.py``: CondAugment, the initial stage, MakeImage,
TextEncoder); each next stage, on R (B, gf, H, W), the words W (B, L,
emb) and the mask:

  r = mean of R over H x W;  g_w = sigmoid(A w_i + B r)
  m_i = relu(M_w w_i) g_w + relu(M_r r) (1 - g_w)
  k_i = relu(key m_i), v_i = relu(value m_i)
  attn = softmax over the real words of R_j . k_i (unscaled);  o_j = attn v
  g_r = sigmoid(response_gate [R_j; o_j]);  R' = o g_r + R (1 - g_r)
  [R'; R'] -> 2 ResBlocks -> UpBlock(2 gf -> gf)

model.py's 1x1 Conv1d / Conv2d layers are Linears over the last axis here,
under the port's names (``A``, ``B``, ``M_w``, ``M_r``, ``key``,
``value``, ``response_gate``), so that one seeded state dict loads into
both. Departure from model.py: each caption's row is masked by its own
mask (model.py's ``mask.repeat(queryL, 1)`` gives a row of a batch > 1
another row's mask).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from perfbench.reference import fp32
from perfbench.reference.generator import (
    NEG_INF,
    CondAugment,
    InitialStage,
    MakeImage,
    ResBlock,
    TextEncoder,
    UpBlock,
    word_mask,
)
from perfbench.reference.layers import Linear, matmul


def memory_read(images: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                mask: torch.Tensor, gate: Linear) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """images (B, C, H, W), key and value (B, L, C), mask (B, L) -> (the
    gated response R' (B, C, H, W), attention maps (B, L, H, W))."""
    b, c, h, w = images.shape
    pix = images.flatten(2).transpose(1, 2)                    # (B, P, C)
    scores = matmul(pix, key.transpose(1, 2))                  # (B, P, L)
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    read = matmul(attn, value)                                 # (B, P, C)
    g = torch.sigmoid(gate(torch.cat([pix, read], -1)))        # (B, P, 1)
    out = read * g + pix * (1.0 - g)
    return (out.transpose(1, 2).reshape(b, c, h, w),
            attn.transpose(1, 2).reshape(b, -1, h, w))


class MemoryStage(nn.Module):
    def __init__(self, gf: int, emb_dim: int, num_residual: int = 2):
        super().__init__()
        self.A = Linear(emb_dim, 1, bias=False)
        self.B = Linear(gf, 1, bias=False)
        self.M_w = Linear(emb_dim, 2 * gf)
        self.M_r = Linear(gf, 2 * gf)
        self.key = Linear(2 * gf, gf)
        self.value = Linear(2 * gf, gf)
        self.response_gate = Linear(2 * gf, 1)
        self.res = nn.ModuleList(ResBlock(2 * gf) for _ in range(num_residual))
        self.up = UpBlock(2 * gf, gf)

    def forward(self, x, words, mask):
        r = x.mean((2, 3))                                     # (B, gf)
        write = torch.sigmoid(self.A(words) + self.B(r)[:, None])
        memory = (torch.relu(self.M_w(words)) * write
                  + torch.relu(self.M_r(r))[:, None] * (1.0 - write))
        key = torch.relu(self.key(memory))
        value = torch.relu(self.value(memory))
        x, attn = memory_read(x, key, value, mask, self.response_gate)
        x = torch.cat([x, x], 1)
        for block in self.res:
            x = block(x)
        return self.up(x), attn


class Generator(nn.Module):
    """(noise, sentence, words, mask, eps) -> ([images (B, R, R, 3) in
    [-1, 1] per stage], [attention maps per memory stage], mu, logvar)."""

    def __init__(self, gf_dim: int, emb_dim: int, z_dim: int, cond_dim: int,
                 num_stages: int = 3, num_residual: int = 2):
        super().__init__()
        self.num_stages = num_stages
        self.ca = CondAugment(emb_dim, cond_dim)
        self.gen1 = InitialStage(16 * gf_dim, z_dim + cond_dim)
        self.img_out1 = MakeImage(gf_dim)
        for s in range(2, num_stages + 1):
            self.add_module(f"gen{s}", MemoryStage(gf_dim, emb_dim,
                                                   num_residual))
            self.add_module(f"img_out{s}", MakeImage(gf_dim))

    def forward(self, noise, sent, words, mask, eps
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           torch.Tensor, torch.Tensor]:
        condition, mu, logvar = self.ca(sent, eps)
        x = self.gen1(noise, condition)
        fakes, attns = [self.img_out1(x)], []
        for s in range(2, self.num_stages + 1):
            x, attn = getattr(self, f"gen{s}")(x, words, mask)
            fakes.append(getattr(self, f"img_out{s}")(x))
            attns.append(attn)
        return fakes, attns, mu, logvar


class Serving(nn.Module):
    """What a DM-GAN serving call computes, under the port's
    ``InferState`` keys (``rnn.*``, ``generator.*``)."""

    def __init__(self, cfg: dict, vocab: int):
        super().__init__()
        self.rnn = TextEncoder(vocab, cfg["text_emb_dim"], cfg["emb_dim"])
        self.generator = Generator(cfg["gf_dim"], cfg["emb_dim"], cfg["z_dim"],
                                   cfg["cond_dim"], cfg["num_stages"],
                                   cfg["num_residual"])

    def forward(self, tokens, lengths, noise, eps):
        """([images (B, R, R, 3) in [0, 1] per stage], [attention maps])."""
        with fp32():
            words, sent = self.rnn(tokens, lengths)
            mask = word_mask(lengths.to(tokens.device), tokens.shape[1])
            fakes, attns, _, _ = self.generator(noise, sent, words, mask, eps)
            return ([torch.clamp(f * 0.5 + 0.5, 0.0, 1.0) for f in fakes],
                    attns)
