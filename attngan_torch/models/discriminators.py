"""Per-resolution discriminators: port of attngan_tpu/models/discriminators.py.

One module keyed by resolution: the 16x image encoder, then at 128 a
DownBlock(16df) and at 256 two (16df, 32df) with a Block3x3(16df), then at
128 and above a Block3x3(8df) back to (B, 8df, 4, 4), and a 4x4 stride-4
conv head with bias -> a sigmoid in fp32: one probability of "real" per
image. The convs run in the compute dtype, BatchNorm keeps its statistics
in fp32 (ops/layers.py::BatchNorm), as the JAX module's.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from attngan_torch.ops.layers import (
    Block3x3LeakyRelu,
    DownBlock,
    ImageEncoder16x,
    conv,
)


class Discriminator(nn.Module):
    """(B, R, R, 3) in [-1, 1], the JAX layout -> (B,) fp32 probability of
    real. Train or eval BatchNorm follows ``.train()`` / ``.eval()``."""

    def __init__(self, df_dim: int = 64, resolution: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolution not in (64, 128, 256):
            raise ValueError(f"no discriminator for {resolution}px")
        self.resolution = resolution
        self.dtype = dtype
        df = df_dim
        self.encoder = ImageEncoder16x(df, dtype)
        widths = {64: (), 128: (16 * df,), 256: (16 * df, 32 * df)}[resolution]
        ins = (8 * df,) + widths
        self.down = nn.ModuleList(DownBlock(a, b, dtype)
                                  for a, b in zip(ins, widths))
        # back to 8df at 4x4: 32df -> 16df -> 8df at 256, 16df -> 8df at 128
        outs = {64: (), 128: (8 * df,), 256: (16 * df, 8 * df)}[resolution]
        ins = ins[-1:] + outs[:-1]
        self.squeeze = nn.ModuleList(Block3x3LeakyRelu(a, b, dtype)
                                     for a, b in zip(ins, outs))
        self.head = nn.Conv2d(8 * df, 1, 4, stride=4, bias=True)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.shape[1:3] != (self.resolution, self.resolution):
            raise ValueError(f"expected {self.resolution}px input, got "
                             f"{tuple(images.shape)}")
        x = self.encoder(images.permute(0, 3, 1, 2))
        for block in (*self.down, *self.squeeze):
            x = block(x)
        return torch.sigmoid(conv(x, self.head, self.dtype).float()).reshape(-1)
