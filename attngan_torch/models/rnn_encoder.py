"""Bidirectional-LSTM text encoder: port of attngan_tpu/models/rnn_encoder.py.

Embedding(vocab, 300) -> dropout(0.5) -> one bidirectional LSTM layer over
the packed (ragged) captions. Word embeddings are the per-step outputs, zero
at padded steps; the sentence embedding is the concat of each direction's
final hidden state. Runs in fp32 (the JAX module has no compute dtype).

Train-mode dropout draws its mask from the ``torch.Generator`` the caller
passes (the JAX module takes an explicit "dropout" key); eval mode is the
identity. A data-parallel rank passes ``shard`` = (its index, the number
of ranks): the mask is drawn for the whole global batch and the rank keeps
its rows, so that n ranks draw what one process draws. The JAX module has one bias per direction: ``bias_hh`` stays zero
and takes no gradient, so that the trained bias is ``bias_ih`` alone.

``forward_masked`` is the same eval-mode function in a form that
``torch.export`` traces (infer/export.py): packing needs the lengths on
the host and the empty-caption branch reads data, so it runs JAX's form
instead, a scan over the fixed ``seq_len`` with the carry frozen and the
output zeroed at padded steps, the backward direction over each row's
words reversed. The live paths keep ``nn.LSTM``.
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
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        seq_len = captions.shape[1]
        x = self.embedding(captions.long())
        if self.training and self.dropout > 0:
            index, count = shard
            b = x.shape[0]
            keep = torch.rand((b * count, *x.shape[1:]), generator=generator,
                              device=x.device)[index * b:(index + 1) * b]
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

    def forward_masked(self, captions: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward``'s eval-mode outputs, traceable: no host lengths, no
        branch on data."""
        x = self.embedding(captions.long())                 # (B, L, E)
        seq_len = x.shape[1]
        steps = torch.arange(seq_len, device=x.device)
        lengths = lengths.to(x.device, torch.int64)[:, None]
        valid = steps[None, :] < lengths                    # (B, L)
        # each row's words reversed, its padding left in place (an
        # involution: it also puts the reversed outputs back)
        order = torch.where(valid, lengths - 1 - steps[None, :],
                            steps[None, :])[..., None]

        def run(x: torch.Tensor, suffix: str):
            lstm = self.lstm
            w_hh = getattr(lstm, "weight_hh_l0" + suffix)
            gates_in = (x @ getattr(lstm, "weight_ih_l0" + suffix).t()
                        + getattr(lstm, "bias_ih_l0" + suffix)
                        + getattr(lstm, "bias_hh_l0" + suffix))
            h = x.new_zeros((x.shape[0], w_hh.shape[1]))
            c = torch.zeros_like(h)
            outputs = []
            for t in range(seq_len):
                i, f, g, o = (gates_in[:, t] + h @ w_hh.t()).chunk(4, dim=-1)
                c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h_new = torch.sigmoid(o) * torch.tanh(c_new)
                keep = valid[:, t, None]
                h = torch.where(keep, h_new, h)
                c = torch.where(keep, c_new, c)
                outputs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
            return torch.stack(outputs, dim=1), h

        fwd, h_fwd = run(x, "")
        reverse = order.expand(-1, -1, x.shape[-1])
        bwd, h_bwd = run(x.gather(1, reverse), "_reverse")
        bwd = bwd.gather(1, order.expand(-1, -1, bwd.shape[-1]))
        return torch.cat([fwd, bwd], dim=-1), torch.cat([h_fwd, h_bwd], dim=-1)
