"""Model FLOPs of one call, counted on the reference.

The products of the reference (convolutions, matmuls, bmm) by
``torch.utils.flop_counter.FlopCounterMode``, on the meta device: shapes
only, nothing runs. The text encoder is written out step by step over the
padded length; what the counter attributes to it is replaced by the count
a packed LSTM needs, 2 * rows * 4H * (E + H) a direction, rows = the real
words (the formula of the port's utils/mfu.py, copied).
Elementwise work is not counted.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.generator import TextEncoder


def lstm_flops(enc: TextEncoder, words: float) -> float:
    hidden, emb = enc.lstm.weight_hh_l0.shape[1], enc.embedding.weight.shape[1]
    return float(2 * 2 * words * 4 * hidden * (emb + hidden))


def model_flops(fn: Callable[[], object], encoders: Iterable[TextEncoder],
                words: float) -> float:
    """FLOPs of ``fn()``; what ``encoders`` count (FlopCounterMode
    attributes it to them by name: the reference calls each one ``rnn``,
    or runs it alone) is replaced by the formula for ``words`` real words
    a call."""
    encoders = list(encoders)
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    by_module = {k: sum(v.values())
                 for k, v in counter.get_flop_counts().items()}
    inside = sum(v for k, v in by_module.items()
                 if k == "TextEncoder" or k.endswith(".rnn"))
    formula = sum(lstm_flops(enc, words) for enc in encoders)
    return float(by_module.get("Global", 0) - inside + formula)


def on_meta(module: nn.Module) -> nn.Module:
    """``module``'s structure on the meta device (no storage)."""
    return module.to_empty(device="meta")
