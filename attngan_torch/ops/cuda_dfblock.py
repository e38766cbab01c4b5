"""K7: DF-GAN's fused DF layer as a CUDA kernel for Hopper.

``lrelu(g1 * lrelu(g0 * x + b0) + b1)`` (LeakyReLU slope 0.2) with one fp32
scale and shift per (sample, channel) for each of the two affines: the
DFBLK of DF-GAN's generator (models/dfgan.py). The kernel is
csrc/dfblock.cu; it replaces no TPU kernel (the JAX package has no DF-GAN).
It reads x once and writes the output once, in fp32 arithmetic with one
rounding to x's type; the ``upsample`` form reads a G_Block's input
(B, H, W, C) and writes the DF layer of its nearest 2x upsample,
(B, 2H, 2W, C), without the upsampled tensor. ``dfblock`` below is its
plain version, which the wrapper runs for a CPU tensor and nowhere else.
Forward only: the port serves DF-GAN and does not train it.

Layouts: x and the output NHWC (the channels_last view of the port's NCHW
tensors); g0, b0, g1, b1 (B, C).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from attngan_torch.ops import _build

SLOPE = 0.2


def dfblock(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
            g1: torch.Tensor, b1: torch.Tensor,
            upsample: bool = False) -> torch.Tensor:
    """Plain version of the kernel: the layer in fp32 on x as stored, one
    rounding to x's type, then (``upsample``) each pixel repeated 2x2."""
    def per_channel(t):
        return t.float()[:, None, None, :]

    y = F.leaky_relu(x.float() * per_channel(g0) + per_channel(b0), SLOPE)
    y = F.leaky_relu(y * per_channel(g1) + per_channel(b1), SLOPE).to(x.dtype)
    if upsample:
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
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
    return lib


def dfblock_cuda(x: torch.Tensor, g0: torch.Tensor, b0: torch.Tensor,
                 g1: torch.Tensor, b1: torch.Tensor,
                 upsample: bool = False) -> torch.Tensor:
    """The fused DF layer -> (B, H, W, C), or (B, 2H, 2W, C) with
    ``upsample``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    if x.device.type == "cpu":
        return dfblock(x, g0, b0, g1, b1, upsample)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    g0, b0, g1, b1 = (t.float().contiguous() for t in (g0, b0, g1, b1))
    check_inputs(x, g0, b0, g1, b1)
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


dfblock_cuda.launches = 0   # kernel launches, for tests and smoke runs
