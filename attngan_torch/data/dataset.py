"""Batch helpers of the data layer (attngan_tpu/data/dataset.py)."""

from __future__ import annotations

import torch


def word_mask(lengths: torch.Tensor, max_seqlen: int) -> torch.Tensor:
    """(B,) lengths -> (B, L) int32 mask, 1 at real words, 0 at padding."""
    steps = torch.arange(max_seqlen, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(torch.int32)
