"""Bidirectional-LSTM text encoder: port of attngan_tpu/models/rnn_encoder.py.

Embedding(vocab, 300) -> dropout(0.5) -> one bidirectional LSTM layer over
the packed (ragged) captions. Word embeddings are the per-step outputs, zero
at padded steps; the sentence embedding is the concat of each direction's
final hidden state. Runs in fp32 (the JAX module has no compute dtype).

Train-mode dropout draws its mask from the ``torch.Generator`` the caller
passes (the JAX module takes an explicit "dropout" key); eval mode is the
identity. The JAX module has one bias per direction: ``bias_hh`` stays zero
and takes no gradient, so that the trained bias is ``bias_ih`` alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class BiLSTMEncoder(nn.Module):
    """captions (B, L) int + lengths (B,) -> (word_embs (B, L, hidden_dim),
    sent_embs (B, hidden_dim)); ``hidden_dim`` is the total of both
    directions."""

    def __init__(self, vocab_size: int, emb_dim: int = 300,
                 hidden_dim: int = 256, dropout: float = 0.5):
        super().__init__()
        if hidden_dim % 2:
            raise ValueError(f"hidden_dim must be even; got {hidden_dim}")
        self.embedding = nn.Embedding(vocab_size, emb_dim)
        nn.init.uniform_(self.embedding.weight, -0.1, 0.1)
        self.dropout = dropout
        self.lstm = nn.LSTM(emb_dim, hidden_dim // 2, batch_first=True,
                            bidirectional=True)
        for bias in (self.lstm.bias_hh_l0, self.lstm.bias_hh_l0_reverse):
            nn.init.zeros_(bias)
            bias.requires_grad_(False)

    def forward(self, captions: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        seq_len = captions.shape[1]
        x = self.embedding(captions.long())
        if self.training and self.dropout > 0:
            keep = torch.rand(x.shape, generator=generator, device=x.device)
            x = torch.where(keep >= self.dropout, x / (1.0 - self.dropout),
                            torch.zeros_like(x))
        # packing needs lengths >= 1 on the host; an empty caption gets
        # zero outputs and a zero sentence embedding, as the JAX scan gives
        lengths = lengths.to("cpu", torch.int64)
        packed = pack_padded_sequence(x, lengths.clamp(min=1),
                                      batch_first=True, enforce_sorted=False)
        out, (h_n, _) = self.lstm(packed)
        words, _ = pad_packed_sequence(out, batch_first=True,
                                       total_length=seq_len)
        sent = torch.cat([h_n[0], h_n[1]], dim=-1)
        empty = lengths == 0            # tested on the host: no device sync
        if bool(empty.any()):
            empty = empty.to(x.device)
            words = words.masked_fill(empty[:, None, None], 0.0)
            sent = sent.masked_fill(empty[:, None], 0.0)
        return words, sent
