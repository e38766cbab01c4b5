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

Three forms compute the eval-mode function, and ``forward`` picks one by
what its input shows:

* K9 (ops/cuda_bilstm.py, csrc/bilstm.cu): CUDA tensors, eval mode, grad
  off, 128 units a direction in fp32. The embedding, one GEMM a direction
  for the input projection, and one launch for both directions'
  recurrence, which reads the lengths where they lie: no host copy, no
  blocking call, so serving captures it in its CUDA graph
  (infer/sampler.py).
* ``nn.LSTM`` over the packed captions: everything else (training, the
  CPU, other widths). Packing needs the lengths on the host.
* ``forward_masked``, K9's plain version and the form that
  ``torch.export`` traces (infer/export.py): JAX's masked scan over the
  fixed ``seq_len``, the carry frozen and the output zeroed at padded
  steps, the backward direction over each row's words reversed; no host
  lengths, no branch on data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from attngan_torch.core.runtime import to_device
from attngan_torch.ops import cuda_bilstm


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

    def kernel_route(self, device: torch.device) -> bool:
        """Whether ``forward`` on ``device`` takes K9: a CUDA device, eval
        mode, grad off, and a width the kernel is built for."""
        return (torch.device(device).type == "cuda" and not self.training
                and not torch.is_grad_enabled()
                and cuda_bilstm.takes_width(self.lstm.hidden_size,
                                            self.lstm.weight_hh_l0.dtype))

    def forward(self, captions: torch.Tensor, lengths,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.kernel_route(captions.device):
            gates, w_hh, b_ih, b_hh = self._projected(captions)
            return cuda_bilstm.bilstm_cuda(
                gates, to_device(lengths, captions.device), w_hh, b_ih, b_hh)
        return self._forward_packed(captions, torch.as_tensor(lengths),
                                    generator, shard)

    def _forward_packed(self, captions, lengths, generator, shard):
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

    def _projected(self, captions: torch.Tensor):
        """K9's operands but the lengths: ((forward, backward) input
        projections x W_ih^T (B, L, 4H)), and the (forward, backward)
        W_hh, bias_ih and bias_hh."""
        x = self.embedding(captions.long())                 # (B, L, E)
        w_ih, w_hh, b_ih, b_hh = (
            tuple(getattr(self.lstm, f"{name}_l0{suffix}")
                  for suffix in ("", "_reverse"))
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        return tuple(x @ w.t() for w in w_ih), w_hh, b_ih, b_hh

    def forward_masked(self, captions: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward``'s eval-mode outputs, traceable: no host lengths, no
        branch on data (K9's plain version)."""
        gates, w_hh, b_ih, b_hh = self._projected(captions)
        return cuda_bilstm.bilstm(gates, lengths, w_hh, b_ih, b_hh)
