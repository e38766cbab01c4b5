"""Adversarial losses and the conditioning-augmentation KL: port of
attngan_tpu/losses/gan.py.

The discriminators output sigmoid probabilities, not logits, and the 1e-8
inside the logs is part of the numerics, as in the JAX package. The
"standard" BCE variant smooths the real labels to U(label_smooth, 1): the
caller passes them as a tensor (the JAX package draws them with
jax.random, which no torch generator reproduces); without them it uses the
midpoint, as the JAX loss does without a key.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def non_saturating_disc_loss(real_probs: torch.Tensor,
                             fake_probs: torch.Tensor) -> torch.Tensor:
    """-mean(log D(x) + log(1 - D(G(z))))."""
    return -torch.mean(torch.log(real_probs + EPS)
                       + torch.log(1.0 - fake_probs + EPS))


def non_saturating_gen_loss(fake_probs: torch.Tensor) -> torch.Tensor:
    """-mean(log D(G(z)))."""
    return -torch.mean(torch.log(fake_probs + EPS))


def _bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    probs = torch.clamp(probs, EPS, 1.0 - EPS)
    return -torch.mean(targets * torch.log(probs)
                       + (1.0 - targets) * torch.log(1.0 - probs))


def standard_disc_loss(real_probs: torch.Tensor, fake_probs: torch.Tensor,
                       real_labels: Optional[torch.Tensor] = None,
                       label_smooth: float = 0.8) -> torch.Tensor:
    """The mean of the real and fake BCE, with smoothed real labels."""
    if real_labels is None:
        real_labels = torch.full_like(real_probs, 0.5 * (label_smooth + 1.0))
    loss_fake = _bce(fake_probs, torch.zeros_like(fake_probs))
    loss_real = _bce(real_probs, real_labels.to(real_probs))
    return 0.5 * (loss_fake + loss_real)


def standard_gen_loss(fake_probs: torch.Tensor) -> torch.Tensor:
    """BCE against all-ones labels."""
    return _bce(fake_probs, torch.ones_like(fake_probs))


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 * mean(1 + logvar - mu^2 - exp(logvar))."""
    return -0.5 * torch.mean(1.0 + logvar - mu.square() - torch.exp(logvar))
