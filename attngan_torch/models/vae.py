"""Alternative image embedders, DFCVAE and a plain conv AutoEncoder: port
of attngan_tpu/models/vae.py.

Reference: networks/VAE.py:11-215 (DFCVAE) and networks/autoencoder.py:
16-123 (AutoEncoder). Both are off the training path: their ``embed``
output can replace the ResNet-18 features that feed the
HierarchicalClusterer (``VAEEmbedder``).

DFCVAE: 8 stride-2 conv blocks 256px -> 1x1x512 (LeakyReLU 0.01), Linear
mu / logvar heads, a mirrored transposed-conv decoder, tanh output; loss =
beta * (pixel MSE + VGG19-BN deep-feature MSE at taps [14, 24, 34, 43]) +
alpha * KLD (VAE.py:164-188). Its ``embed`` returns the LOGVAR vector, a
reference quirk kept deliberately (VAE.py:199-215).

AutoEncoder: 8 DownBlockLeakyReLU -> Linear bottleneck (mu / logvar) ->
Linear -> 8 UpBlockReLU + tanh; loss = pixel MSE + mean KLD
(autoencoder.py:79-83); ``embed`` returns the sampled z.

The decoder's transposed convs are flax's ``ConvTranspose(3, strides=2,
padding="SAME")``: no kernel flip, output cropped to 2H x 2W from the top
left. ``ConvTransposeSame`` keeps the kernel in torch's (I, O, kH, kW)
layout ALREADY FLIPPED (convert.convert_vae_flat flips a flax kernel), and
runs ``conv_transpose2d`` without padding, cropped; torch's usual
``padding=1, output_padding=1`` is one pixel off it.

Layouts: images (B, H, W, 3) in [-1, 1] and out (the JAX layouts), NCHW in
channels_last memory inside. The reparametrization noise ``eps`` can be
passed in (JAX draws it with jax.random) or drawn from a
``torch.Generator``. Train or eval BatchNorm follows ``.train()`` /
``.eval()``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from attngan_torch.core.runtime import resolve_device
from attngan_torch.ops.layers import (
    BatchNorm,
    DownBlockLeakyReLU,
    UpBlockReLU,
    conv,
)

DFC_HIDDEN_DIMS = (4, 8, 16, 32, 64, 128, 256, 512)
DFC_SLOPE = 0.01            # the DFCVAE's LeakyReLU (VAE.py); the blocks: 0.2


def _reparametrize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(std.shape, generator=generator, device=std.device,
                          dtype=std.dtype)
    return mu + eps.to(std) * std


class ConvTransposeSame(nn.ConvTranspose2d):
    """flax ``ConvTranspose(3, strides=2, padding="SAME")``: (B, I, H, W)
    -> (B, O, 2H, 2W), in ``dtype``. The weight is (I, O, 3, 3), the flax
    kernel's spatial flip."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, 3, stride=2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               self.bias.to(self.dtype), stride=2)
        return y[:, :, :2 * h, :2 * w]


class DFCVAE(nn.Module):
    """forward(x (B, 256, 256, 3), eps=None, generator=None) -> (recons,
    mu, logvar). The input side is 2 ** len(hidden_dims): the encoder ends
    at 1 x 1."""

    def __init__(self, latent_dim: int = 128,
                 hidden_dims: Sequence[int] = DFC_HIDDEN_DIMS,
                 alpha: float = 1.0, beta: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_dim, self.alpha, self.beta = latent_dim, alpha, beta
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        widths = (3,) + self.hidden_dims
        self.encoder = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2, padding=1)
                                     for a, b in zip(widths, widths[1:]))
        self.enc_bn = nn.ModuleList(BatchNorm(w) for w in self.hidden_dims)
        self.fc_mu = nn.Linear(self.hidden_dims[-1], latent_dim)
        self.fc_var = nn.Linear(self.hidden_dims[-1], latent_dim)
        rev = self.hidden_dims[::-1]
        self.decoder_input = nn.Linear(latent_dim, rev[0])
        dec = list(zip(rev, rev[1:])) + [(rev[-1], rev[-1])]
        self.decoder = nn.ModuleList(ConvTransposeSame(a, b, dtype)
                                     for a, b in dec)
        self.dec_bn = nn.ModuleList(BatchNorm(b) for _, b in dec)
        self.out_conv = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        for layer, bn in zip(self.encoder, self.enc_bn):
            h = F.leaky_relu(bn(conv(h, layer, self.dtype)), DFC_SLOPE)
        h = h.flatten(1).float()                       # (B, 512) at 1 x 1
        mu, logvar = self.fc_mu(h), self.fc_var(h)
        z = _reparametrize(mu, logvar, eps, generator)
        y = self.decoder_input(z)[:, :, None, None]
        for layer, bn in zip(self.decoder, self.dec_bn):
            y = F.leaky_relu(bn(layer(y)), DFC_SLOPE)
        recons = torch.tanh(conv(y, self.out_conv, self.dtype).float())
        return recons.permute(0, 2, 3, 1), mu, logvar


def dfc_vae_loss(recons: torch.Tensor, inputs: torch.Tensor,
                 mu: torch.Tensor, logvar: torch.Tensor,
                 recons_features: Optional[List[torch.Tensor]] = None,
                 input_features: Optional[List[torch.Tensor]] = None,
                 alpha: float = 1.0, beta: float = 0.5) -> torch.Tensor:
    """beta * (pixel MSE + deep-feature MSE) + alpha * KLD (VAE.py:164-188)."""
    recons_loss = torch.mean(torch.square(recons - inputs))
    feature_loss = 0.0
    if recons_features is not None:
        for r, i in zip(recons_features, input_features):
            feature_loss = feature_loss + torch.mean(torch.square(r - i))
    kld = torch.mean(-0.5 * torch.sum(
        1 + logvar - torch.square(mu) - torch.exp(logvar), dim=1))
    return beta * (recons_loss + feature_loss) + alpha * kld


class AutoEncoder(nn.Module):
    """forward(x (B, 256, 256, 3), eps=None, generator=None) -> (z,
    decoded, mu, logvar)."""

    WIDTHS = (8, 16, 32, 64, 128, 256, 512, 1024)
    UP_WIDTHS = (512, 256, 128, 64, 32, 16, 8, 3)

    def __init__(self, nz: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nz = self.latent_dim = nz
        widths = (3,) + self.WIDTHS
        self.down = nn.ModuleList(DownBlockLeakyReLU(a, b, dtype)
                                  for a, b in zip(widths, widths[1:]))
        self.fc1 = nn.Linear(1024, 512)
        self.fc21 = nn.Linear(512, nz)
        self.fc22 = nn.Linear(512, nz)
        self.fc3 = nn.Linear(nz, 512)
        self.fc4 = nn.Linear(512, 1024)
        up = (1024,) + self.UP_WIDTHS
        self.up = nn.ModuleList(UpBlockReLU(a, b, dtype)
                                for a, b in zip(up, up[1:]))

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = x.permute(0, 3, 1, 2)
        for block in self.down:
            h = block(h)
        h1 = self.fc1(h.flatten(1).float())            # (B, 1024) at 1 x 1
        mu, logvar = self.fc21(h1), self.fc22(h1)
        z = _reparametrize(mu, logvar, eps, generator)
        y = self.fc4(F.relu(self.fc3(z)))[:, :, None, None]
        for block in self.up:
            y = block(y)
        decoded = torch.tanh(y.float()).permute(0, 2, 3, 1)
        return z, decoded, mu, logvar


def autoencoder_loss(recon_x: torch.Tensor, x: torch.Tensor,
                     mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Pixel MSE + mean KLD (reference autoencoder.py:79-83)."""
    mse = torch.mean(torch.square(recon_x - x))
    kld = -0.5 * torch.mean(torch.mean(
        1 + logvar - torch.square(mu) - torch.exp(logvar), dim=1))
    return mse + kld


class VAEEmbedder:
    """Frozen batched embedder with the reference ``embed`` contracts:
    DFCVAE -> logvar (VAE.py:199-215, quirk kept); AutoEncoder -> the
    sampled z (autoencoder.py:107-123). Interchangeable with
    models.resnet.ImageEmbedder for the clusterer: ``model`` (its weights
    included) runs in eval mode on ``device`` (default: the GPU). The
    noise is one draw a batch from a CPU ``torch.Generator`` seeded
    ``seed``, moved to the device: the same embeddings on every device."""

    def __init__(self, model: nn.Module, kind: str = "dfc", seed: int = 0,
                 device: str | torch.device | None = None):
        if kind not in ("dfc", "ae"):
            raise ValueError(f"kind must be 'dfc' or 'ae'; got {kind!r}")
        self.kind = kind
        self.device = resolve_device(device)
        self.model = model.eval().requires_grad_(False).to(
            self.device, memory_format=torch.channels_last)
        self.generator = torch.Generator().manual_seed(seed)

    def embed(self, images, batch_size: int = 32,
              eps: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
        """(M, H, W, 3) fp32 images (numpy, or a tensor on any device) ->
        (M, latent) fp32 numpy embeddings, ``batch_size`` images a forward;
        ``eps``, where given, is each batch's noise in place of a draw."""
        images = torch.as_tensor(images)
        out = []
        with torch.inference_mode():
            for i, start in enumerate(range(0, images.shape[0], batch_size)):
                batch = images[start:start + batch_size].to(
                    self.device, torch.float32)
                noise = eps[i] if eps is not None else torch.randn(
                    (batch.shape[0], self.model.latent_dim),
                    generator=self.generator)
                result = self.model(batch, torch.as_tensor(noise).to(
                    self.device))
                out.append((result[2] if self.kind == "dfc"
                            else result[0]).float().cpu())
        return torch.cat(out).numpy()
