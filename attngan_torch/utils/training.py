"""Runtime training helpers (reference utilities/training.py:19-58): port
of attngan_tpu/utils/training.py.

The reference's ``Training`` static class is kept as plain functions.
Noise comes from an explicit ``torch.Generator`` (the reference used the
implicit global ``torch.randn``).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["calculate_out_hw", "noise_vector", "scale_1_to_255",
           "scale_255_to_1"]


def calculate_out_hw(hw: int, k: int, s: int, p: int = 0) -> int:
    """Conv output size: floor((hw + 2p - k) / s) + 1."""
    return (hw + 2 * p - k) // s + 1


def scale_255_to_1(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return (images - 127.5) / 127.5


def scale_1_to_255(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255]."""
    return images * 127.5 + 127.5


def noise_vector(generator: Optional[torch.Generator], n_examples: int,
                 n_hidden: int, device: str | torch.device | None = None
                 ) -> torch.Tensor:
    """N(0, 1) fp32 noise of shape (n_examples, n_hidden) on ``device``
    (the generator's own device by default), drawn from ``generator``."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    return torch.randn((n_examples, n_hidden), generator=generator,
                       device=device)
