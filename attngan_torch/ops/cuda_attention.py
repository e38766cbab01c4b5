"""K1: the generator's word attention as a CUDA kernel for Hopper.

Replaces attngan_tpu/ops/pallas_attention.py (``word_attention_pallas``).
The kernel is csrc/word_attention.cu; its plain version is
ops/attention.py::word_attention, which this wrapper runs for a CPU tensor
and nowhere else. The backward recomputes through the plain version, as
``_word_attention_pallas_bwd`` does through the jnp reference.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Tuple

import torch

from attngan_torch.ops import _build
from attngan_torch.ops.attention import NEG_INF, word_attention

MAX_WORDS = 32


class WordAttention(torch.autograd.Function):
    """``forward_impl`` computes the outputs (the kernel on the GPU); the
    gradient is the plain version's, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, images, words, mask, forward_impl: Callable):
        ctx.save_for_backward(images, words, mask)
        return forward_impl(images, words, mask)

    @staticmethod
    def backward(ctx, d_context, d_attn):
        images, words, mask = ctx.saved_tensors
        with torch.enable_grad():
            im = images.detach().requires_grad_(ctx.needs_input_grad[0])
            wd = words.detach().requires_grad_(ctx.needs_input_grad[1])
            inputs = [t for t in (im, wd) if t.requires_grad]
            outputs = word_attention(im, wd, mask)
            grads = iter(torch.autograd.grad(outputs, inputs,
                                             (d_context, d_attn)))
        return (next(grads) if im.requires_grad else None,
                next(grads) if wd.requires_grad else None, None, None)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("word_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.word_attention.argtypes = [i, p, p, p, p, p, i, i, i, i,
                                   ctypes.c_float, p]
    lib.word_attention.restype = i
    return lib


def _launch(images: torch.Tensor, words: torch.Tensor,
            mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = images.shape
    l = words.shape[1]
    if images.dtype not in _build.DTYPE_CODES or words.dtype != images.dtype:
        raise TypeError(f"word_attention_cuda takes fp32 or bf16 images and "
                        f"words of the same type; got {images.dtype}, "
                        f"{words.dtype}")
    if words.shape != (b, l, c) or mask.shape != (b, l):
        raise ValueError(f"shapes disagree: images {tuple(images.shape)}, "
                         f"words {tuple(words.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"word_attention_cuda takes 1..{MAX_WORDS} words; "
                         f"got {l}")
    if c % 4 or (l * c + l) * 4 > 48 * 1024:
        raise ValueError(f"channels must be a multiple of 4 with "
                         f"(L*C + L) fp32 within 48 KiB; got C={c}, L={l}")
    for name, t in (("images", images), ("words", words), ("mask", mask)):
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on "
                             f"{images.device}")
    for name, t in (("images", images), ("words", words)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    bias = torch.where(mask == 0, NEG_INF, 0.0).to(torch.float32).contiguous()
    context = torch.empty_like(images)
    attn = torch.empty((b, l, h, w), dtype=torch.float32, device=images.device)
    status = _lib().word_attention(
        _build.DTYPE_CODES[images.dtype], images.data_ptr(), words.data_ptr(),
        bias.data_ptr(), context.data_ptr(), attn.data_ptr(), b, h * w, c, l,
        1.0 / math.sqrt(c), torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(status, "word_attention")
    word_attention_cuda.launches += 1
    return context, attn


def word_attention_cuda(images: torch.Tensor, words: torch.Tensor,
                        mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused word attention: (context (B,H,W,C), attn (B,L,H,W) fp32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    if images.device.type == "cpu":
        return word_attention(images, words, mask)
    if images.device.type != "cuda":
        raise ValueError(f"no kernel for device {images.device}")
    return WordAttention.apply(images, words, mask, _launch)


word_attention_cuda.launches = 0   # kernel launches, for tests and smoke runs
