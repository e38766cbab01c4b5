"""The port's MFU accounting (utils/mfu.py) on the CPU.

- ``model_flops`` of a tiny 3-stage sampling call on the plain path equals
  a count by hand of its products: the BiLSTM by formula over the packed
  steps, the Linears, every conv (2 x outputs x 9 x C_in), the word
  attention's two bmm a stage.
- The BiLSTM formula equals FlopCounterMode's own count where the counter
  sees the LSTM's products (a packed input on the CPU), is added where it
  sees none (a padded input on the CPU, where the LSTM is one op of 0
  FLOPs to it; a blinded LSTM: forward only under no_grad, 3x under
  grad), and is never added twice.
- ``mfu_report`` has JAX's keys and arithmetic; the peak table knows the
  H100 (989 TFLOP/s bf16) and nothing else: None for another card and
  for the CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.utils._python_dispatch import _disable_current_modes

from attngan_tpu.utils import mfu as jax_mfu

from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.tools.mfu_report import plain
from attngan_torch.utils import mfu


def _conv(b, side, ci, co, k=3):
    return 2 * b * side * side * k * k * ci * co


def test_model_flops_of_a_sampling_call_equals_a_count_by_hand():
    b, vocab, gf, emb, z, cond, seq = 2, 11, 4, 16, 100, 100, 4
    cfg = plain(GanConfig(gf_dim=gf, emb_dim=emb, seq_len=seq,
                          compute_dtype="float32"))
    assert not (cfg.fused_attention or cfg.fused_upsample
                or cfg.fused_similarity)
    torch.manual_seed(0)
    sampler = Sampler(InferState(cfg, vocab), device="cpu")
    tokens = torch.randint(0, vocab, (b, seq))
    lengths = torch.tensor([4, 2])
    got, images = mfu.model_flops(sampler.generate_from_tokens, tokens,
                                  lengths, generator=torch.Generator(),
                                  modules=[sampler.state])
    assert images.shape == (b, 256, 256, 3)

    text_e, h = 300, emb // 2
    want = 2 * int(lengths.sum()) * 4 * h * (text_e + h) * 2   # BiLSTM
    want += 2 * b * emb * 4 * cond                             # CondAugment
    ng = 16 * gf
    want += 2 * b * (z + cond) * ng * 4 * 4 * 2                # gen1 fc
    for i, div in enumerate((2, 4, 8, 16)):                    # gen1 UpBlocks
        want += _conv(b, 8 * 2 ** i, ng * 2 // div, 2 * ng // div)
    for side in (64, 128, 256):                                # MakeImage
        want += _conv(b, side, gf, 3)
    for side in (64, 128):                                     # gen2, gen3
        want += 2 * b * seq * emb * gf                         # word_proj
        want += 2 * (2 * b * side * side * seq * gf)           # two bmm
        want += 2 * (_conv(b, side, 2 * gf, 4 * gf)
                     + _conv(b, side, 2 * gf, 2 * gf))          # 2 ResBlocks
        want += _conv(b, 2 * side, 2 * gf, 2 * gf)             # UpBlock
    assert got == want


def _lstm_inputs():
    x = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(0))
    packed = nn.utils.rnn.pack_padded_sequence(
        x, torch.tensor([5, 3, 2]), batch_first=True, enforce_sorted=False)
    return x, packed


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_lstm_formula_is_the_counters_own_and_is_added_once(packed):
    from torch.utils.flop_counter import FlopCounterMode

    lstm = nn.LSTM(6, 4, batch_first=True, bidirectional=True)
    x = _lstm_inputs()[int(packed)]
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        lstm(x)
    rows = 10 if packed else 15
    formula = mfu._lstm_flops(lstm, x)
    assert formula == 2 * rows * 4 * 4 * (6 + 4) * 2
    # torch's CPU LSTM: a padded input is one op the counter counts as 0;
    # a packed one decomposes into products it counts, the formula's
    assert counter.get_total_flops() == (formula if packed else 0)
    with torch.no_grad():
        seen, _ = mfu.model_flops(lstm, x, modules=[lstm])
    assert seen == formula

    class Blind(nn.LSTM):       # the counter sees none of its products
        def forward(self, *args):
            with _disable_current_modes():
                return super().forward(*args)

    blind = Blind(6, 4, batch_first=True, bidirectional=True)
    with torch.no_grad():
        assert mfu.model_flops(blind, x, modules=[blind])[0] == seen
        assert mfu.model_flops(blind, x)[0] == 0    # not among ``modules``
    assert mfu.model_flops(blind, x, modules=[blind])[0] == 3 * seen
    blind.requires_grad_(False)
    assert mfu.model_flops(blind, x, modules=[blind])[0] == seen


def test_mfu_report_contract(monkeypatch):
    got = mfu.mfu_report(2e12, 0.5, "cpu")
    want = jax_mfu.mfu_report(2e12, 0.5, device=None)
    assert set(got) == set(want) == {"device_kind", "achieved_tflops",
                                     "peak_tflops", "mfu"}
    assert got["achieved_tflops"] == want["achieved_tflops"] == 4.0
    assert got == {"device_kind": "cpu", "achieved_tflops": 4.0,
                   "peak_tflops": None, "mfu": None}
    assert mfu.device_peak_flops("cpu") == ("cpu", None)
    assert mfu.mfu_report(None, 0.5, "cpu")["achieved_tflops"] is None

    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
        assert mfu.device_peak_flops("cuda") == (name, peak)
        line = mfu.mfu_report(98.9e12, 1.0, "cuda")
        assert line["device_kind"] == name
        if peak:
            assert line["peak_tflops"] == 989.0 and line["mfu"] == 0.1
        else:
            assert line["peak_tflops"] is None and line["mfu"] is None
    assert np.isclose(mfu.mfu_report(1e12, 2.0, "cuda")["achieved_tflops"],
                      0.5)
