"""Generator word attention, plain PyTorch (the plain version of K1).

Port of attngan_tpu/ops/attention.py::word_attention. Layouts are the JAX
package's: images (B, H, W, C), words (B, L, C), mask (B, L), attention
maps (B, L, H, W). The products accumulate in fp32 whatever the input type
(JAX's ``preferred_element_type=float32``), and the attention is rounded to
the words' type before the context product, so this function repeats the
arithmetic of the CUDA kernel (ops/cuda_attention.py) step for step.
"""

from __future__ import annotations

import math
from typing import Tuple

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
