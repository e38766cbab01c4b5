"""ResNet-18 image embedder for the clustering captioner: port of
attngan_tpu/models/resnet.py.

Reference: networks/cnn_embedder.py:14-38 — a frozen torchvision resnet18
minus its fc layer; ``embed`` batches images through it and returns (M, 512)
features that the HierarchicalClusterer reduces and clusters
(data/bedrooms.py:255-259). Module names are torchvision's resnet18
state_dict keys (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer2.0.downsample.0`` / ``.1``, ...), so a torchvision state_dict minus
``fc`` loads by name; ``convert.load_resnet_flat`` loads the JAX package's
flax variables.

Layouts: ``ResNet18`` takes NHWC images (B, H, W, 3), the JAX package's
layout, and views them as NCHW in channels_last memory (no copy).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.core.runtime import resolve_device

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch's; flax's retain factor 0.9


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """conv3x3 (stride) -> BN -> relu -> conv3x3 -> BN, plus the identity
    or, where the block strides, a 1x1 strided conv and its BN; relu."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1,
                               bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, features, 1, stride, bias=False),
                _bn(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet18(nn.Module):
    """(B, H, W, 3) -> (B, 512) pooled features (fc removed, as in the
    reference's ``Sequential(*children[:-1])``, cnn_embedder.py:17-18)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        in_features = 64
        for idx, (features, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)], start=1):
            setattr(self, f"layer{idx}", nn.Sequential(
                BasicBlock(in_features, features, stride),
                BasicBlock(features, features)))
            in_features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for idx in range(1, 5):
            x = getattr(self, f"layer{idx}")(x)
        return x.mean(dim=(2, 3))          # adaptive avg pool to 1x1


def init_resnet18(seed: int = 0) -> ResNet18:
    """A ResNet18 with torchvision's initialisation (He normal, fan_out, on
    every conv; BN weight 1, bias 0) drawn from a ``torch.Generator``
    seeded with ``seed``, on the CPU: the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    model = ResNet18()
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            nn.init.kaiming_normal_(module.weight, mode="fan_out",
                                    nonlinearity="relu", generator=gen)
    return model


class ImageEmbedder:
    """Frozen batched embedder (reference ImageEmbedder.embed, :28-38):
    a ResNet18 in eval mode, fp32, channels_last, on ``device`` (default:
    the GPU). ``variables`` is a ResNet18 state_dict (a torchvision one
    minus ``fc``, or ``convert.convert_resnet_flat``'s); without one the
    weights are ``init_resnet18(seed)``'s. On the GPU its convs use TF32
    where ``torch.backends.cudnn.allow_tf32`` lets them (PyTorch's
    default)."""

    def __init__(self, variables: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        model = init_resnet18(seed)
        if variables is not None:
            model.load_state_dict(variables, strict=True)
        self.model = model.eval().requires_grad_(False).to(
            self.device, memory_format=torch.channels_last)

    def embed(self, images, batch_size: int = 32) -> np.ndarray:
        """(M, H, W, 3) fp32 images (numpy, or a tensor on any device) ->
        (M, 512) fp32 numpy features, ``batch_size`` images a forward."""
        images = torch.as_tensor(images)
        out = []
        with torch.inference_mode():
            for start in range(0, images.shape[0], batch_size):
                batch = images[start:start + batch_size].to(
                    self.device, torch.float32)
                out.append(self.model(batch).cpu())
        return torch.cat(out).numpy()
