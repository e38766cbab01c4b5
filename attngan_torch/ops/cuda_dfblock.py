"""K7: DF-GAN's fused DF layer as a CUDA kernel for Hopper.

``lrelu(g1 * lrelu(g0 * x + b0) + b1)`` (LeakyReLU slope 0.2) with one fp32
scale and shift per (sample, channel) for each of the two affines: the
DFBLK of DF-GAN's generator (models/dfgan.py). The kernel is
csrc/dfblock.cu; it replaces no TPU kernel (the JAX package has no DF-GAN).
It reads x once and writes the output once, in fp32 arithmetic with one
rounding to x's type; the ``upsample`` form reads a G_Block's input
(B, H, W, C) and writes the DF layer of its nearest 2x upsample,
(B, 2H, 2W, C), without the upsampled tensor; the resize form (``size``)
does the same for a nearest resize to any (Ho, Wo), each output pixel
reading the source pixel PyTorch's ``nearest`` picks (GALIP's G_Blocks,
7^2 -> 8^2 and 64^2 -> 224^2). ``dfblock`` below is its plain version,
which the wrapper runs for a CPU tensor and nowhere else.
Forward only: the port serves DF-GAN and does not train it.

Layouts: x and the output NHWC (the channels_last view of the port's NCHW
tensors); g0, b0, g1, b1 (B, C).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attngan_torch.ops import _build

SLOPE = 0.2


def nearest_scale(size_in: int, size_out: int) -> np.float32:
    """PyTorch's scale of a ``nearest`` resize: in / out in float32."""
    return np.float32(size_in) / np.float32(size_out)


def nearest_index(size_in: int, size_out: int) -> torch.Tensor:
    """The source index of each of ``size_out`` pixels in a ``nearest``
    resize, as PyTorch and the kernel compute it: floor(o * scale) in
    float32, clamped to the last pixel."""
    o = torch.arange(size_out, dtype=torch.float32)
    scale = torch.tensor(nearest_scale(size_in, size_out))
    return torch.clamp(torch.floor(o * scale).long(), max=size_in - 1)


def dfblock(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
            g1: torch.Tensor, b1: torch.Tensor, upsample: bool = False,
            size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain version of the kernel: the layer in fp32 on x as stored, one
    rounding to x's type, then (``upsample``) each pixel repeated 2x2 or
    (``size``) the pixels ``nearest_index`` picks."""
    def per_channel(t):
        return t.float()[:, None, None, :]

    y = F.leaky_relu(x.float() * per_channel(g0) + per_channel(b0), SLOPE)
    y = F.leaky_relu(y * per_channel(g1) + per_channel(b1), SLOPE).to(x.dtype)
    if upsample:
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    elif size is not None:
        rows = nearest_index(x.shape[1], size[0]).to(y.device)
        cols = nearest_index(x.shape[2], size[1]).to(y.device)
        y = y[:, rows][:, :, cols]
    return y.contiguous()


def check_inputs(x: torch.Tensor, *constants: torch.Tensor) -> None:
    """Raise on anything csrc/dfblock.cu does not take."""
    if x.dim() != 4:
        raise ValueError(f"dfblock_cuda: x must be (B, H, W, C); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dfblock_cuda takes fp32 or bf16; got {x.dtype}")
    b, c = x.shape[0], x.shape[3]
    v = _build.vector_values(x.dtype)
    if c % v or c // v > 256 or not 1 <= b <= 65535:
        raise ValueError(f"dfblock_cuda: C={c} must be a multiple of {v} "
                         f"and at most {256 * v} ({x.dtype}), B={b} in "
                         f"1..65535")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("dfblock_cuda: x must be contiguous NHWC, 16-byte "
                         "aligned")
    for t in constants:
        if t.shape != (b, c) or t.dtype != torch.float32:
            raise ValueError(f"dfblock_cuda: each scale and shift must be "
                             f"({b}, {c}) fp32; got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dfblock_cuda: scales and shifts must be "
                             f"contiguous, 16-byte aligned, on {x.device}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dfblock")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dfblock.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dfblock.restype = i
    f = ctypes.c_float
    lib.dfblock_resize.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, f,
                                   f, p]
    lib.dfblock_resize.restype = i
    return lib


def dfblock_cuda(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
                 g1: torch.Tensor, b1: torch.Tensor, upsample: bool = False,
                 size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The fused DF layer -> (B, H, W, C), (B, 2H, 2W, C) with
    ``upsample``, or (B, Ho, Wo, C) with ``size`` = (Ho, Wo): the layer of
    x's nearest resize (the resize form; a 2x resize is the upsampling
    form's, which callers take with ``upsample``).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    if x.device.type == "cpu":
        return dfblock(x, g0, b0, g1, b1, upsample, size)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    g0, b0, g1, b1 = (t.float().contiguous() for t in (g0, b0, g1, b1))
    check_inputs(x, g0, b0, g1, b1)
    if size is not None:
        return _resize(x, g0, b0, g1, b1, size)
    b, h, w, c = x.shape
    scale = 2 if upsample else 1
    out = torch.empty((b, scale * h, scale * w, c), dtype=x.dtype,
                      device=x.device)
    status = _lib().dfblock(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), g0.data_ptr(),
        b0.data_ptr(), g1.data_ptr(), b1.data_ptr(), out.data_ptr(), b, h, w,
        c, int(upsample), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "dfblock")
    dfblock_cuda.launches += 1
    return out


def _resize(x, g0, b0, g1, b1, size: Tuple[int, int]) -> torch.Tensor:
    """K7's resize form on checked inputs."""
    b, h, w, c = x.shape
    ho, wo = (int(s) for s in size)
    if ho < 1 or wo < 1:
        raise ValueError(f"dfblock_cuda: size must be positive; got {size}")
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    status = _lib().dfblock_resize(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), g0.data_ptr(),
        b0.data_ptr(), g1.data_ptr(), b1.data_ptr(), out.data_ptr(), b, h, w,
        c, ho, wo, float(nearest_scale(h, ho)), float(nearest_scale(w, wo)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "dfblock_resize")
    dfblock_cuda.launches += 1
    return out


dfblock_cuda.launches = 0   # kernel launches, for tests and smoke runs
