"""Seeded weights, made on the device in one draw, for the port and the
reference alike.

The reference's modules carry the port's parameter and buffer names, so a
state dict made from them loads strictly into both. Every random value
comes from one ``torch.randn`` call on the device, cut into the tensors
and scaled: weights of two or more dimensions by 1/sqrt(fan-in), the
embedding by 0.1, biases by 0.05, BatchNorm scales 1 + 0.1 n and shifts 0.1 n. The
LSTM's ``bias_hh`` are zero, as the port keeps them; running statistics
start at mean 0, variance 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from perfbench.reference.layers import BatchNorm


def _kinds(module: nn.Module) -> Dict[str, str]:
    bn = {name for name, m in module.named_modules() if isinstance(m, BatchNorm)}
    kinds = {}
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        parent, _, leaf = name.rpartition(".")
        if leaf in ("running_mean", "running_var", "bias_hh_l0",
                    "bias_hh_l0_reverse"):
            kinds[name] = leaf
        elif parent in bn:
            kinds[name] = "bn_" + leaf
        elif t.dim() == 1:
            kinds[name] = "bias"
        elif parent.endswith("embedding"):
            kinds[name] = "embedding"
        else:
            kinds[name] = "weight"
    return kinds


def seeded_state(module: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A full state dict for ``module`` (built on any device, the meta
    device included), in fp32 on ``device``."""
    kinds = _kinds(module)
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    drawn = [k for k in shapes if kinds[k] not in (
        "running_mean", "running_var", "bias_hh_l0", "bias_hh_l0_reverse")]
    total = sum(math.prod(shapes[k]) for k in drawn)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        kind = kinds[k]
        if kind == "running_var":
            out[k] = torch.ones(shape, device=device)
            continue
        if k not in drawn:
            out[k] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind == "bn_bias":
            x = 0.1 * x
        elif kind == "bias":
            x = 0.05 * x
        elif kind == "embedding":
            x = 0.1 * x
        else:
            x = x / math.sqrt(fan_in)
        out[k] = x
    return out
