"""The text encoder and the 3-stage attentional generator, plain fp32.

AttnGAN's generator (Xu et al. 2018, Fig. 2), as the port lays it out:
CondAugment (Linear -> GLU -> mu, logvar; c = mu + eps * exp(logvar / 2)),
the initial stage (Linear without bias -> BN -> GLU -> (B, 16 gf, 4, 4),
read as NHWC, then four UpBlocks to 64^2), two next stages (word attention
of each pixel over the projected words, scaled by 1/sqrt(C) as the ku222
generator scales it, concat, two ResBlocks, an UpBlock), and a conv3x3 ->
tanh image at each stage. The text encoder is the bidirectional LSTM of
``nn.LSTM`` written out step by step: each direction runs over a row's
real words only, padded steps give zeros, and the sentence is the two
final hidden states.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.layers import (
    BatchNorm,
    Conv,
    Linear,
    glu,
    matmul,
)

NEG_INF = -1e9


def word_mask(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    steps = torch.arange(seq_len, device=lengths.device)
    return steps[None, :] < lengths[:, None]


class _LSTMWeights(nn.Module):
    """``nn.LSTM``'s parameter names for one bidirectional layer."""

    def __init__(self, emb_dim: int, hidden: int):
        super().__init__()
        for suffix in ("_l0", "_l0_reverse"):
            self.register_parameter("weight_ih" + suffix, nn.Parameter(
                torch.empty(4 * hidden, emb_dim)))
            self.register_parameter("weight_hh" + suffix, nn.Parameter(
                torch.empty(4 * hidden, hidden)))
            self.register_parameter("bias_ih" + suffix, nn.Parameter(
                torch.empty(4 * hidden)))
            self.register_parameter("bias_hh" + suffix, nn.Parameter(
                torch.empty(4 * hidden)))


class TextEncoder(nn.Module):
    """tokens (B, L), lengths (B,) -> (words (B, L, 2H), sentence (B, 2H)).
    ``keep``, where given, is the dropout draw U(0, 1) of shape (B, L, E):
    an embedding is kept, scaled by 1 / (1 - p), where keep >= p."""

    def __init__(self, vocab: int, emb_dim: int = 300, hidden_dim: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        self.embedding = nn.Module()
        self.embedding.weight = nn.Parameter(torch.empty(vocab, emb_dim))
        self.lstm = _LSTMWeights(emb_dim, hidden_dim // 2)
        self.dropout = dropout

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                keep: Optional[torch.Tensor] = None):
        x = F.embedding(tokens.long(), self.embedding.weight)
        if keep is not None:
            x = torch.where(keep >= self.dropout, x / (1.0 - self.dropout),
                            torch.zeros_like(x))
        seq_len = x.shape[1]
        steps = torch.arange(seq_len, device=x.device)
        lengths = lengths.to(x.device, torch.int64)[:, None]
        valid = steps[None, :] < lengths
        # each row's words reversed in place, the padding where it was
        order = torch.where(valid, lengths - 1 - steps[None, :],
                            steps[None, :])[..., None]

        def run(x: torch.Tensor, suffix: str):
            lstm = self.lstm
            w_hh = getattr(lstm, "weight_hh" + suffix)
            gates_in = (matmul(x, getattr(lstm, "weight_ih" + suffix).t())
                        + getattr(lstm, "bias_ih" + suffix)
                        + getattr(lstm, "bias_hh" + suffix))
            h = x.new_zeros((x.shape[0], w_hh.shape[1]))
            c = torch.zeros_like(h)
            outputs = []
            for t in range(seq_len):
                i, f, g, o = (gates_in[:, t] + matmul(h, w_hh.t())).chunk(
                    4, dim=-1)
                c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h_new = torch.sigmoid(o) * torch.tanh(c_new)
                live = valid[:, t, None]
                h = torch.where(live, h_new, h)
                c = torch.where(live, c_new, c)
                outputs.append(torch.where(live, h_new, torch.zeros_like(h_new)))
            return torch.stack(outputs, dim=1), h

        fwd, h_fwd = run(x, "_l0")
        bwd, h_bwd = run(x.gather(1, order.expand(-1, -1, x.shape[-1])),
                         "_l0_reverse")
        bwd = bwd.gather(1, order.expand(-1, -1, bwd.shape[-1]))
        return torch.cat([fwd, bwd], -1), torch.cat([h_fwd, h_bwd], -1)


def word_attention(images: torch.Tensor, words: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, C, H, W), words (B, L, C), mask (B, L) -> (context (B, C,
    H, W), attention maps (B, L, H, W))."""
    b, c, h, w = images.shape
    pix = images.flatten(2).transpose(1, 2)                    # (B, P, C)
    scores = matmul(pix, words.transpose(1, 2)) / math.sqrt(c)  # (B, P, L)
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    context = matmul(attn, words)                              # (B, P, C)
    return (context.transpose(1, 2).reshape(b, c, h, w),
            attn.transpose(1, 2).reshape(b, -1, h, w))


class UpBlock(nn.Module):
    """2x nearest upsample -> conv3x3(2 out) -> BN -> GLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, 2 * cout, 3, padding=1)
        self.bn = BatchNorm(2 * cout)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return glu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, 2 * c, 3, padding=1)
        self.bn1 = BatchNorm(2 * c)
        self.conv2 = Conv(c, c, 3, padding=1)
        self.bn2 = BatchNorm(c)

    def forward(self, x):
        return self.bn2(self.conv2(glu(self.bn1(self.conv1(x))))) + x


class CondAugment(nn.Module):
    def __init__(self, emb_dim: int, cond_dim: int):
        super().__init__()
        self.cond_dim = cond_dim
        self.fc = Linear(emb_dim, 4 * cond_dim)

    def forward(self, sent, eps):
        x = glu(self.fc(sent), dim=-1)
        mu, logvar = x[:, :self.cond_dim], x[:, self.cond_dim:]
        return mu + eps * torch.exp(0.5 * logvar), mu, logvar


class InitialStage(nn.Module):
    def __init__(self, ng: int, cin: int):
        super().__init__()
        self.ng = ng
        self.fc = Linear(cin, ng * 4 * 4 * 2, bias=False)
        self.bn = BatchNorm(ng * 4 * 4 * 2)
        self.up = nn.ModuleList(UpBlock(ng // (d // 2), ng // d)
                                for d in (2, 4, 8, 16))

    def forward(self, noise, condition):
        x = glu(self.bn(self.fc(torch.cat([noise, condition], -1))), dim=-1)
        x = x.view(-1, 4, 4, self.ng).permute(0, 3, 1, 2)     # NHWC features
        for block in self.up:
            x = block(x)
        return x


class NextStage(nn.Module):
    def __init__(self, gf: int, emb_dim: int, num_residual: int = 2):
        super().__init__()
        self.word_proj = Linear(emb_dim, gf, bias=False)
        self.res = nn.ModuleList(ResBlock(2 * gf) for _ in range(num_residual))
        self.up = UpBlock(2 * gf, gf)

    def forward(self, x, word_embs, mask):
        context, attn = word_attention(x, self.word_proj(word_embs), mask)
        x = torch.cat([x, context], 1)
        for block in self.res:
            x = block(x)
        return self.up(x), attn


class MakeImage(nn.Module):
    def __init__(self, gf: int):
        super().__init__()
        self.conv = Conv(gf, 3, 3, padding=1)

    def forward(self, x):
        return torch.tanh(self.conv(x)).permute(0, 2, 3, 1)


class Generator(nn.Module):
    """(noise, sentence, words, mask, eps) -> ([images (B, R, R, 3) in
    [-1, 1] per stage], [attention maps per attention stage], mu, logvar)."""

    def __init__(self, gf_dim: int, emb_dim: int, z_dim: int, cond_dim: int,
                 num_stages: int = 3, num_residual: int = 2):
        super().__init__()
        self.num_stages = num_stages
        self.ca = CondAugment(emb_dim, cond_dim)
        self.gen1 = InitialStage(16 * gf_dim, z_dim + cond_dim)
        self.img_out1 = MakeImage(gf_dim)
        for s in range(2, num_stages + 1):
            self.add_module(f"gen{s}", NextStage(gf_dim, emb_dim,
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
    """What a serving call computes: the eval text encoder and generator;
    the port's ``InferState`` keys (``rnn.*``, ``generator.*``)."""

    def __init__(self, cfg: dict, vocab: int):
        super().__init__()
        self.rnn = TextEncoder(vocab, cfg["text_emb_dim"], cfg["emb_dim"])
        self.generator = Generator(cfg["gf_dim"], cfg["emb_dim"], cfg["z_dim"],
                                   cfg["cond_dim"], cfg["num_stages"],
                                   cfg["num_residual"])

    def forward(self, tokens, lengths, noise, eps):
        """([images (B, R, R, 3) in [0, 1] per stage], [attention maps])."""
        words, sent = self.rnn(tokens, lengths)
        mask = word_mask(lengths.to(tokens.device), tokens.shape[1])
        fakes, attns, _, _ = self.generator(noise, sent, words, mask, eps)
        return [torch.clamp(f * 0.5 + 0.5, 0.0, 1.0) for f in fakes], attns
