"""Attention primitives, plain PyTorch.

``word_attention`` is the plain version of K1 (generator word attention);
``memory_read`` is the plain version of K1's memory form (DM-GAN's
key-value memory read and response gate); ``damsm_attention`` is the DAMSM
word-region attention (AttnGAN Eq. 7-9).
Port of attngan_tpu/ops/attention.py. Layouts are the JAX
package's: images (B, H, W, C), words (B, L, C), mask (B, L), attention
maps (B, L, H, W). The products accumulate in fp32 whatever the input type
(JAX's ``preferred_element_type=float32``), and the attention is rounded to
the words' type before the context product, so this function repeats the
arithmetic of the CUDA kernel (ops/cuda_attention.py) step for step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# Large-negative fill for masked logits. Not -inf: a fully-masked row would
# give exp(-inf - -inf) = NaN (attngan_tpu/ops/attention.py:30-32).
NEG_INF = -1e9


def word_attention(
    images: torch.Tensor,   # (B, H, W, C) pixel features (query)
    words: torch.Tensor,    # (B, L, C) projected word features (key, value)
    mask: torch.Tensor,     # (B, L) 1 for real words, 0 for padding
    scaled: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels attend over words: (context (B,H,W,C), attn (B,L,H,W) fp32)."""
    b, h, w, c = images.shape
    pix = images.reshape(b, h * w, c).float()
    scores = torch.einsum("bpc,blc->bpl", pix, words.float())
    if scaled:
        scores = scores * (1.0 / math.sqrt(c))
    scores = scores.masked_fill(mask[:, None, :] == 0, NEG_INF)
    attn = torch.softmax(scores, dim=-1)                          # (B, P, L)
    context = torch.einsum("bpl,blc->bpc", attn.to(words.dtype).float(),
                           words.float()).to(images.dtype)
    attn_maps = attn.transpose(1, 2).reshape(b, -1, h, w)        # (B, L, H, W)
    return context.reshape(b, h, w, c), attn_maps


def memory_read(
    images: torch.Tensor,   # (B, H, W, C) pixel features r (query)
    key: torch.Tensor,      # (B, L, C) memory keys
    value: torch.Tensor,    # (B, L, C) memory values
    mask: torch.Tensor,     # (B, L) 1 for real words, 0 for padding
    gate_w: torch.Tensor,   # (2C,) the response gate's weight over [r; o]
    gate_b: torch.Tensor,   # (1,) its bias
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DM-GAN's memory read and response gate (Zhu et al. 2019, Eq. 6-9):
    (out (B, H, W, 2C) in the images' type, attn (B, L, H, W) fp32).

    Unscaled logits r . k, a masked softmax over the words, o = attn . v,
    all in fp32 (attn is not rounded before the product); the gate
    g = sigmoid(gate_w . [r; o] + gate_b) and r' = o g + r (1 - g) in fp32,
    rounded once to the images' type and written into both halves of the
    output (DM-GAN's ``cat((r', r'), 1)``)."""
    b, h, w, c = images.shape
    pix = images.reshape(b, h * w, c).float()
    scores = torch.einsum("bpc,blc->bpl", pix, key.float())
    scores = scores.masked_fill(mask[:, None, :] == 0, NEG_INF)
    attn = torch.softmax(scores, dim=-1)                          # (B, P, L)
    read = torch.einsum("bpl,blc->bpc", attn, value.float())
    gate_w = gate_w.float()
    gate = torch.sigmoid(pix @ gate_w[:c] + read @ gate_w[c:]
                         + gate_b.float())[..., None]
    r = (read * gate + pix * (1.0 - gate)).to(images.dtype)
    out = torch.cat([r, r], dim=-1).reshape(b, h, w, 2 * c)
    return out, attn.transpose(1, 2).reshape(b, -1, h, w)


def damsm_attention(
    query: torch.Tensor,            # (B, L, D) word embeddings
    context: torch.Tensor,          # (B, R, D) image region features
    gamma1: float = 4.0,
    mask: Optional[torch.Tensor] = None,  # (B, L) 1 = real word; None = all
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Words attend over regions: (weighted (B, L, D), attn (B, L, R)).

    Softmax #1 normalizes over the words of each region (scores scaled by
    1/sqrt(D), padded words filled with NEG_INF); the transposed result is
    sharpened by gamma1 and softmax #2 normalizes over the regions of each
    word; the weighted context mixes the regions by the second attention."""
    d = query.shape[-1]
    scores = torch.einsum("brd,bld->brl", context.float(),
                          query.float()) * (1.0 / math.sqrt(d))
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :] == 0, NEG_INF)
    attn = torch.softmax(scores, dim=-1)                         # over words
    attn = torch.softmax(attn.transpose(1, 2) * gamma1, dim=-1)  # over regions
    weighted = torch.einsum("blr,brd->bld", attn.to(context.dtype).float(),
                            context.float()).to(query.dtype)
    return weighted, attn
