"""K8: the generator's eval BatchNorm epilogue as a CUDA kernel for Hopper.

One pass over an NHWC tensor x of C channels, in one of two forms:

* GLU (``skip`` None): ``glu(bn(x))``, the first C/2 channels of the eval
  BatchNorm times the sigmoid of the last C/2, -> (..., C/2);
* residual: ``bn(x) + skip`` -> (..., C).

The kernel is csrc/bn_epilogue.cu; it replaces no TPU kernel (XLA fuses
this chain there). It takes BatchNorm's four fp32 vectors and eps and folds
them per channel itself, so no fold is launched and a CUDA graph's replay
reads the statistics as they are then; it computes in fp32 with one
rounding to x's type. ``bn_epilogue`` below is its plain version, which the
wrapper runs for a CPU tensor and nowhere else. Forward only: training
keeps PyTorch's chain (ops/layers.py routes it there).

Layouts: x and skip (..., C) contiguous, C last (the channels_last view of
the port's NCHW tensors; a (B, C) tensor is B pixels); weight, bias,
running_mean, running_var (C,).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from attngan_torch.ops import _build


def bn_epilogue(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                mean: torch.Tensor, var: torch.Tensor, eps: float,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel: the fold and the form in fp32 on x as
    stored, one rounding to x's type."""
    k = weight.float() * torch.rsqrt(var.float() + eps)
    y = x.float() * k + (bias.float() - mean.float() * k)
    if skip is not None:
        return (y + skip.float()).to(x.dtype)
    a, g = y.chunk(2, dim=-1)
    return (a * torch.sigmoid(g)).to(x.dtype)


def out_channels(c: int, residual: bool) -> int:
    return c if residual else c // 2


def takes(x: torch.Tensor, constants,
          skip: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes these operands (``check_inputs`` raises on
    the rest)."""
    return _refusal(x, constants, skip) is None


def check_inputs(x: torch.Tensor, constants,
                 skip: Optional[torch.Tensor] = None) -> None:
    """Raise on anything csrc/bn_epilogue.cu does not take."""
    refusal = _refusal(x, constants, skip)
    if refusal is not None:
        error, message = refusal
        raise error(f"bn_epilogue_cuda: {message}")


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _refusal(x, constants, skip):
    """(exception type, why) where the kernel does not take the operands,
    else None."""
    if x.device.type != "cuda":
        return ValueError, f"no kernel for device {x.device}"
    if x.dtype not in _build.DTYPE_CODES:
        return TypeError, f"takes fp32 or bf16; got {x.dtype}"
    if x.dim() < 2 or not _aligned(x):
        return ValueError, (f"x must be contiguous (..., C), 16-byte "
                            f"aligned; got {tuple(x.shape)}")
    c = x.shape[-1]
    v = _build.vector_values(x.dtype)
    out = out_channels(c, skip is not None)
    pixels = x.numel() // c
    if (skip is None and c % 2) or out % v or not 1 <= pixels < 2 ** 30:
        return ValueError, (f"the output's channels ({out} of C={c}) must "
                            f"be a multiple of {v} ({x.dtype}), the pixels "
                            f"({pixels}) in 1..2^30")
    if skip is not None and (skip.shape != x.shape or skip.dtype != x.dtype
                             or skip.device != x.device
                             or not _aligned(skip)):
        return ValueError, (f"skip must be x's shape and type, contiguous, "
                            f"16-byte aligned; got {tuple(skip.shape)} "
                            f"{skip.dtype}")
    for t in constants:
        if (t.shape != (c,) or t.dtype != torch.float32
                or t.device != x.device or not _aligned(t)):
            return ValueError, (f"BatchNorm's vectors must be ({c},) fp32, "
                                f"contiguous, 16-byte aligned, on {x.device}; "
                                f"got {tuple(t.shape)} {t.dtype}")
    return None


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_epilogue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bn_epilogue.argtypes = [i, p, p, p, p, p, p, ctypes.c_float, p, i, i,
                                p]
    lib.bn_epilogue.restype = i
    return lib


def bn_epilogue_cuda(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, eps: float,
                     skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``glu(bn(x))`` -> (..., C/2), or with ``skip`` ``bn(x) + skip`` ->
    (..., C), from BatchNorm's weight, bias, running_mean, running_var and
    eps.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    constants = (weight, bias, mean, var)
    if x.device.type == "cpu":
        return bn_epilogue(x, *constants, eps, skip)
    check_inputs(x, constants, skip)
    c = x.shape[-1]
    out = torch.empty(x.shape[:-1] + (out_channels(c, skip is not None),),
                      dtype=x.dtype, device=x.device)
    status = _lib().bn_epilogue(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        None if skip is None else skip.data_ptr(),
        *(t.data_ptr() for t in constants), eps, out.data_ptr(),
        x.numel() // c, c, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "bn_epilogue")
    bn_epilogue_cuda.launches += 1
    return out


bn_epilogue_cuda.launches = 0   # kernel launches, for tests and smoke runs
