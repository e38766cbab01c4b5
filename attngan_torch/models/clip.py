"""CLIP's transformers as GALIP serves them: the text tower and the visual
tower's residual blocks.

Radford et al., "Learning Transferable Visual Models From Natural Language
Supervision", ICML 2021 (arXiv:2103.00020); the modules of openai/CLIP's
``clip/model.py`` (``ResidualAttentionBlock``, ``Transformer``, the text
half of ``CLIP``), with its parameter names, so that its state dict loads
as it is. A residual block on x (B, L, W):

  x = x + out_proj(MHA(ln_1(x)))       8 or 12 heads of 64; the text's
                                       causal (-inf above the diagonal)
  x = x + c_proj(QuickGELU(c_fc(ln_2(x))))     c_fc W -> 4W;
                                       QuickGELU(t) = t sigmoid(1.702 t)

The text tower (``CLIPText``): tokens (B, 77) in CLIP's layout (SOT, the
caption's ids, EOT, then 0) -> token_embedding + positional_embedding ->
12 causal blocks -> ln_final at the EOT token (the largest id: argmax) ->
@ text_projection, the sentence embedding (B, embed). The word features
are not computed: GALIP's generator reads the sentence only.

How the port computes them: the residual stream, every LayerNorm (eps
1e-5, as CLIP's fp32 LayerNorm) and the text projection in fp32, each
residual added in place; the GEMMs in the compute dtype (weights cast at
the call, as ops/layers.py's convs); the attention through K11
(ops/cuda_clip_attention.py), which reads the packed in_proj output as
it stands; QuickGELU in the compute dtype. The EOT is found by argmax on
the device, so the tower holds no host sync and replays in the
sampler's CUDA graph.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.core.config import GanConfig
from attngan_torch.core.runtime import compute_dtype
from attngan_torch.ops.cuda_clip_attention import HEAD_DIM, clip_attention_cuda
from attngan_torch.ops.int8 import intercept

LN_EPS = 1e-5
TEXT_LAYERS = 12        # the text transformer's residual blocks


def linear_in(layer: nn.Linear, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``layer`` on x in ``dtype`` (weights cast at the call), or an int8
    interceptor's site."""
    out = intercept(layer, x)
    if out is not None:
        return out
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """CLIP's LayerNorm: in fp32, whatever x's type."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS)


class QuickGELU(nn.Module):
    """t sigmoid(1.702 t), in t's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """nn.MultiheadAttention's parameters (the packed ``in_proj_weight`` /
    ``in_proj_bias`` and ``out_proj``), computed by K11."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        if width != heads * HEAD_DIM:
            raise ValueError(f"CLIP's heads are {HEAD_DIM} wide: width "
                             f"{width} is not {heads} x {HEAD_DIM}")
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, causal: bool,
                dtype: torch.dtype) -> torch.Tensor:
        """x (B, L, W) in ``dtype`` -> out_proj(MHA(x)) in ``dtype``."""
        qkv = F.linear(x, self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        return linear_in(self.out_proj,
                         clip_attention_cuda(qkv, self.heads, causal), dtype)


class ResidualAttentionBlock(nn.Module):
    """clip/model.py's ResidualAttentionBlock; ``forward`` adds both
    residuals into x (fp32) in place and returns it."""

    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn = Attention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width))]))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        dt = self.dtype
        x.add_(self.attn(layer_norm(x, self.ln_1).to(dt), causal, dt))
        h = self.mlp.gelu(linear_in(self.mlp.c_fc, layer_norm(x, self.ln_2),
                                    dt))
        return x.add_(linear_in(self.mlp.c_proj, h, dt))


class Transformer(nn.Module):
    """The blocks under clip/model.py's ``resblocks``."""

    def __init__(self, width: int, layers: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype) for _ in range(layers))


class CLIPText(nn.Module):
    """CLIP's text tower. forward(tokens (B, context), lengths=None) ->
    (None, sentence (B, embed) fp32): the BiLSTM's (words, sentence)
    signature, with no word features; ``lengths`` is not read (the EOT
    token ends a caption)."""

    def __init__(self, vocab_size: int = 49408, context: int = 77,
                 width: int = 512, heads: int = 8, embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context, width))
        self.transformer = Transformer(width, TEXT_LAYERS, heads, dtype)
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(
            width ** -0.5 * torch.randn(width, embed_dim))
        nn.init.normal_(self.token_embedding.weight, std=0.02)

    @classmethod
    def from_config(cls, cfg: GanConfig, vocab_size: int) -> "CLIPText":
        return cls(vocab_size, cfg.seq_len, cfg.clip_width, cfg.clip_heads,
                   cfg.emb_dim, compute_dtype(cfg.compute_dtype))

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[None, torch.Tensor]:
        x = self.token_embedding(tokens) + self.positional_embedding
        for block in self.transformer.resblocks:
            x = block(x, causal=True)
        # ln_final is per token: only the EOT rows are normalised
        eot = tokens.argmax(dim=-1)
        pooled = torch.take_along_dim(x, eot[:, None, None], dim=1)[:, 0]
        return None, layer_norm(pooled, self.ln_final) @ self.text_projection


def clip_layout(ids: torch.Tensor, lengths: torch.Tensor, context: int,
                vocab_size: int) -> torch.Tensor:
    """Captions' ids (B, >= max length; 1 <= id < vocab_size - 2) in
    CLIP's layout (B, context): SOT (vocab_size - 2), the ids, EOT
    (vocab_size - 1), then 0; CLIP's vocabulary of 49,408 gives its 49406
    and 49407."""
    b = ids.shape[0]
    lengths = torch.as_tensor(lengths, device=ids.device).view(b, 1)
    if int(lengths.max()) + 2 > context:
        raise ValueError(f"a caption of {int(lengths.max())} ids does not "
                         f"fit CLIP's context of {context} with SOT and EOT")
    steps = torch.arange(context, device=ids.device)
    body = torch.zeros((b, context), dtype=torch.long, device=ids.device)
    n = min(ids.shape[1], context - 1)
    body[:, 1:n + 1] = ids[:, :n]
    tokens = torch.where((steps >= 1) & (steps <= lengths), body, 0)
    tokens[:, 0] = vocab_size - 2
    return torch.where(steps == lengths + 1, vocab_size - 1, tokens)
