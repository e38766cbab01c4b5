"""The work counts against counts by hand."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn

from perfbench import counts
from perfbench.counts import kernels
from perfbench.counts.flops import lstm_flops, model_flops, on_meta
from perfbench.reference.generator import TextEncoder
from perfbench.reference.layers import Conv, Linear


def test_peaks():
    assert counts.PEAK_BF16_FLOPS == 989e12
    assert counts.PEAK_HBM_BYTES == 3.35e12


def test_upblock_bound_by_hand():
    b, h, w, ci, co = 64, 128, 128, 64, 32
    flops = 2 * b * 256 * 256 * 64 * 64 * 4        # 2x2 taps a parity
    nbytes = 2 * (b * h * w * ci + 64 * ci * 9 + b * 256 * 256 * co) + 4 * 128
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert kernels.upblock_bound_s(b, h, w, ci, co) == pytest.approx(want)
    assert flops / 989e12 > nbytes / 3.35e12       # bound by operations
    # a serving call at 64: 64^2 -> 128^2 and 128^2 -> 256^2
    assert list(kernels.serve_upblocks(64, 32, 3)) == [
        (64, 64, 64, 64, 32), (64, 128, 128, 64, 32)]


def test_model_flops_of_products_by_hand():
    conv = Conv(3, 8, 3, padding=1)
    lin = Linear(8, 5)
    m = on_meta(nn.ModuleList([conv, lin]))
    x = torch.empty((2, 3, 10, 10), device="meta")
    flops = model_flops(lambda: m[1](m[0](x).mean((2, 3))), [], 0)
    assert flops == 2 * 2 * 100 * 8 * 27 + 2 * 2 * 8 * 5


def test_text_encoder_counted_by_formula():
    """The written-out LSTM runs every padded step; its products are
    replaced by the packed LSTM's for the real words."""
    enc = on_meta(TextEncoder(50, 12, 8))
    tokens = torch.zeros((3, 6), dtype=torch.long, device="meta")
    lengths = torch.tensor([2, 6, 4])
    h, e, words = 4, 12, 12
    want = 2 * 2 * words * 4 * h * (e + h)
    assert lstm_flops(enc, words) == want
    with torch.no_grad():
        assert model_flops(lambda: enc(tokens, lengths), [enc], words) == want
