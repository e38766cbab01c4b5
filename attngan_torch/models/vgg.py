"""VGG19-BN feature extractor for the DFCVAE's deep-feature-consistent loss:
port of attngan_tpu/models/vgg.py.

Reference: networks/VAE.py:82-88,143-162, a frozen torchvision vgg19_bn
whose ``features`` Sequential is walked module by module, collecting the
outputs at indices [14, 24, 34, 43]. ``VGG19BNFeatures.features`` is that
Sequential with torchvision's indices, so its state_dict keys are
torchvision's (``features.0.weight``, ``features.1.running_mean``, ...):
``convert.load_torchvision_vgg19_bn`` loads a torchvision ``.pth`` by name
(the classifier and the BN counters dropped), ``convert.load_vgg_flat``
the JAX package's variables.

Layouts: images (B, H, W, 3) in, taps (B, h, w, C) out (the JAX layouts),
NCHW in channels_last memory inside.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.ops.layers import BatchNorm, conv

# VGG-19 configuration "E": conv widths with 'M' max pools between stages.
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

DEFAULT_FEATURE_LAYERS = (14, 24, 34, 43)  # reference VAE.py:150


def _torch_module_index_plan() -> List[Tuple[int, str, int]]:
    """[(torch module index, kind, width)] for vgg19_bn.features: each conv
    entry expands to conv, bn, relu; 'M' is one max pool."""
    plan, idx = [], 0
    for entry in VGG19_CFG:
        if entry == "M":
            plan.append((idx, "pool", 0))
            idx += 1
        else:
            plan.append((idx, "conv", entry))
            plan.append((idx + 1, "bn", entry))
            plan.append((idx + 2, "relu", entry))
            idx += 3
    return plan


def _collect_at(taps: Sequence[int]) -> dict:
    """{module index whose output is collected: the tap it answers}.

    The reference appends the raw tensor after module ``t``, but
    torchvision's ``ReLU(inplace=True)`` then MUTATES a tap taken at a
    BatchNorm index before the loss reads it: its effective feature is the
    output of the following ReLU, t + 1. Conv taps stay pre-BN. Taps t and
    t + 1 with t a BatchNorm would collect one tensor twice: refused."""
    kind_at = {idx: kind for idx, kind, _ in _torch_module_index_plan()}
    collect_at = {}
    for t in taps:
        at = t + 1 if kind_at[t] == "bn" else t
        if at in collect_at:
            raise ValueError(
                f"taps {collect_at[at]} and {t} collide: a BN tap {t} is "
                f"collected at index {at} (post inplace-ReLU) — pick "
                "non-adjacent taps")
        collect_at[at] = t
    return collect_at


class VGG19BNFeatures(nn.Module):
    """forward(images (B, H, W, 3)) -> [the outputs at ``taps`` (torchvision
    module indices), each (B, h, w, C)].

    Frozen and eval only: the parameters take no gradient (the input
    does) and ``train()`` leaves the module in eval mode. The convs run in
    ``dtype`` (fp32 by default); BN folds its fp32 statistics."""

    def __init__(self, taps: Sequence[int] = DEFAULT_FEATURE_LAYERS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.dtype = dtype
        self._collect_at = _collect_at(self.taps)
        layers, in_features = [], 3
        for _, kind, width in _torch_module_index_plan():
            if kind == "conv":
                layers.append(nn.Conv2d(in_features, width, 3, padding=1))
                in_features = width
            elif kind == "bn":
                layers.append(BatchNorm(width))
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)
        self.train(False)

    def train(self, mode: bool = True) -> "VGG19BNFeatures":
        return super().train(False)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.permute(0, 3, 1, 2)
        outputs = {}
        last = max(self._collect_at)
        for idx, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                x = conv(x, layer, self.dtype)
            elif isinstance(layer, nn.ReLU):
                x = F.relu(x)
            else:
                x = layer(x)
            if idx in self._collect_at:
                outputs[self._collect_at[idx]] = x.permute(0, 2, 3, 1)
            if idx == last:
                break
        return [outputs[t] for t in self.taps]
