"""Model-FLOP utilization: port of attngan_tpu/utils/mfu.py.

``model_flops`` counts the products of one call (convolutions, matmuls,
bmm and attention, forward and backward) with
``torch.utils.flop_counter.FlopCounterMode``. That counter sees aten ops
only: the port's hand-written kernels (ctypes launches) are invisible to
it, and so is ``nn.LSTM`` (0 FLOPs on the CPU). So:

* count a call on the PLAIN path (the kernel switches off, or CPU
  tensors), where every product is an aten op: the count is then the
  model's work, whatever implements it; time the call on the kernel path;
* every ``nn.LSTM`` under ``modules`` whose forward the counter does not
  see gets its products by formula: 2 * rows * 4H * (E + H) a direction
  (rows = the packed steps, or B * T), and twice that again for the
  backward when its weights take a gradient.

Elementwise work (activations, BN, softmax, casts) is not counted, where
XLA's cost analysis, which the JAX module reads, counts it: the port's
FLOPs sit below XLA's for the same program.

The peak table holds one card, keyed by ``torch.cuda.get_device_name()``:
the H100's dense bf16 rate, 989 TFLOP/s (NVIDIA's data sheet, SXM, at
700 W). It is the denominator for fp32 programs too, as in the JAX module:
"how much of the card is left". Other cards and the CPU have no peak.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.utils.rnn import PackedSequence
from torch.utils.flop_counter import FlopCounterMode

# substring of the device name -> peak dense bf16 FLOP/s
_PEAKS = (("H100", 989e12),)


def device_peak_flops(device=None) -> Tuple[str, Optional[float]]:
    """(device name, peak FLOP/s or None for another card or the CPU)."""
    device = torch.device(device if device is not None else
                          "cuda" if torch.cuda.is_available() else "cpu")
    if device.type != "cuda":
        return "cpu", None
    kind = torch.cuda.get_device_name(device)
    for sub, peak in _PEAKS:
        if sub in kind:
            return kind, peak
    return kind, None


def _lstm_flops(lstm: nn.LSTM, x) -> int:
    """Forward products of one ``nn.LSTM`` call on input ``x``."""
    if isinstance(x, PackedSequence):
        rows = x.data.shape[0]
    else:
        rows = x.shape[0] * x.shape[1] if x.dim() == 3 else x.shape[0]
    h = lstm.hidden_size
    total, width = 0, lstm.input_size
    for _ in range(lstm.num_layers):
        total += 2 * rows * 4 * h * (width + h)
        width = h * (2 if lstm.bidirectional else 1)
    return total * (2 if lstm.bidirectional else 1)


def model_flops(fn: Callable, *args, modules: Iterable[nn.Module] = (),
                **kwargs) -> Tuple[float, object]:
    """(products of ``fn(*args, **kwargs)`` in FLOPs, its result): see the
    module docstring. ``modules``: the models whose ``nn.LSTM`` layers the
    call runs."""
    counter = FlopCounterMode(display=False)
    extra, before, hooks = [0], {}, []

    def pre(module, inputs):
        before[id(module)] = counter.get_total_flops()

    def post(module, inputs, output):
        if counter.get_total_flops() == before[id(module)]:
            n = _lstm_flops(module, inputs[0])
            grad = torch.is_grad_enabled() and any(
                p.requires_grad for p in module.parameters())
            extra[0] += n * (3 if grad else 1)

    lstms = {id(m): m for root in modules for m in root.modules()
             if isinstance(m, nn.LSTM)}
    for lstm in lstms.values():
        hooks.append(lstm.register_forward_pre_hook(pre))
        hooks.append(lstm.register_forward_hook(post))
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return float(counter.get_total_flops() + extra[0]), out


def mfu_report(flops_per_call: Optional[float], seconds_per_call: float,
               device=None) -> dict:
    """{'device_kind', 'achieved_tflops', 'peak_tflops', 'mfu'}: entries
    are None where the count or the peak table can't say."""
    kind, peak = device_peak_flops(device)
    achieved = (flops_per_call / seconds_per_call
                if flops_per_call and seconds_per_call > 0 else None)
    return {
        "device_kind": kind,
        "achieved_tflops": round(achieved / 1e12, 3) if achieved else None,
        "peak_tflops": round(peak / 1e12, 1) if peak else None,
        "mfu": round(achieved / peak, 4) if achieved and peak else None,
    }
