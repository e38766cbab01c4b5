"""K1: the generator's word attention as a CUDA kernel for Hopper, and its
memory form.

Replaces attngan_tpu/ops/pallas_attention.py (``word_attention_pallas``).
The kernel is csrc/word_attention.cu (``word_attention_stream_kernel``):
persistent blocks that stream tiles of pixels through a ring of bulk
copies, ``plan`` below sizes its tiles, lanes, ring and grid. Its plain
version is ops/attention.py::word_attention, which this wrapper runs for a
CPU tensor and nowhere else. The backward recomputes through the plain
version, as ``_word_attention_pallas_bwd`` does through the jnp reference.

``memory_read_cuda`` is the same streaming kernel's memory form
(``memread_stream_kernel``, K10 in PERF.md's table): DM-GAN's key-value
memory read with its response gate fused in (models/dmgan.py), whose
plain version is ops/attention.py::memory_read. It serves only: it has no
backward, and refuses inputs that need one.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Tuple

import torch

from attngan_torch.ops import _build
from attngan_torch.ops.attention import memory_read, word_attention

MAX_WORDS = 32
# the kernel's plan (csrc/word_attention.cu): a tile of at most MAX_TILE
# pixels and about STAGE_BYTES; a ring of STAGES tiles (the kernel takes up
# to MAX_STAGES; on the H100 two were faster than three or four,
# attngan_torch/tools/attention_plans.py); blocks of 8 warps, two an SM
# where their shared memory fits
STAGE_BYTES = 16 * 1024
MAX_TILE = 256
STAGES = 2
MAX_STAGES = 4
BLOCKS_PER_SM = 2
SMEM_LIMIT = 227 * 1024     # shared memory a block may have on the H100,
SM_SMEM = 228 * 1024        # an SM has,
SMEM_RESERVED = 1024        # and the SM keeps per block


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def chunk_values(c: int, itemsize: int) -> int:
    """Values a lane holds of a pixel's row: 16 bytes where C allows it
    (fp32 always, bf16 at C % 8 == 0), else 4 (bf16 at C % 8 == 4)."""
    return 16 // itemsize if c * itemsize % 16 == 0 else 4


def word_slots(l: int) -> int:
    """Words the kernel computes (its kWords): L itself up to 8, else 16 or
    32, the words past L zero and masked."""
    return l if l <= 8 else 16 if l <= 16 else 32


def smem_bytes(c: int, l: int, itemsize: int, pt: int, g: int,
               stages: int, memory: bool = False) -> int:
    """A block's shared memory, as csrc/word_attention.cu::Layout lays it
    out: barriers, fp32 words (the memory form: keys, values and the
    gate's 2C + 1 floats) and mask flags (``word_slots`` rows), two (L, ld)
    attention tiles whose rows fall in other banks, the ring."""
    ld = pt + max(4, 32 // g)
    words = word_slots(l)
    valid_off = 128 + _round_up(words * c * 4, 16)
    if memory:
        valid_off += (_round_up(words * c * 4, 16)
                      + _round_up((2 * c + 1) * 4, 16))
    ring_off = _round_up(_round_up(valid_off + words * 4, 128)
                         + 2 * l * ld * 4, 128)
    return ring_off + stages * _round_up(pt * c * itemsize, 128)


class Plan(NamedTuple):
    pt: int        # pixels of a tile (the last tile of an image may be short)
    g: int         # lanes that share a pixel
    stages: int    # ring stages
    blocks: int    # blocks an SM whose shared memory fits
    grid: int      # persistent blocks
    tiles: int     # tiles of an image
    units: int     # work units (image, tile), b-major


def plan(b: int, p: int, c: int, l: int, itemsize: int, sms: int,
         memory: bool = False) -> Plan:
    """How the kernel covers (B, P, C) images: G lanes a pixel (the largest
    power of two up to 32 that the row's chunks fill), tiles of pt pixels
    (a multiple of the block's pass, 8 warps x 32/G pixels x the pixels a
    lane takes, where a stage holds one), a ring of STAGES tiles, two
    blocks an SM where their shared memory fits (else one), and
    min(units, blocks a wave) blocks, block i taking units
    [units*i/grid, units*(i+1)/grid). ``memory``: the memory form's
    shared memory."""
    nc = c // chunk_values(c, itemsize)
    g = 1 << (min(nc, 32).bit_length() - 1)
    per_pass = 8 * (32 // g) * (2 if word_slots(l) <= 8 else 1)
    pt = min(MAX_TILE, max(1, STAGE_BYTES // (c * itemsize)))
    if pt >= per_pass:
        pt -= pt % per_pass
    elif pt >= 4:
        pt -= pt % 4
    pt = min(pt, _round_up(p, 4))
    smem = smem_bytes(c, l, itemsize, pt, g, STAGES, memory)
    blocks = next((n for n in (BLOCKS_PER_SM, 1)
                   if smem <= min(SMEM_LIMIT, SM_SMEM // n - SMEM_RESERVED)),
                  None)
    if blocks is None:
        raise ValueError(f"no plan fits shared memory: C={c}, L={l}")
    tiles = -(-p // pt)
    units = b * tiles
    return Plan(pt, g, STAGES, blocks, min(units, blocks * sms), tiles, units)


def block_units(pl: Plan, block: int) -> range:
    """The units block ``block`` walks, as the kernel computes them."""
    return range(pl.units * block // pl.grid,
                 pl.units * (block + 1) // pl.grid)


def unit_tile(pl: Plan, u: int, p: int, row_bytes: int):
    """(image, first pixel, pixels, bulk) of unit u: its tile goes by bulk
    copy when its byte count and its offset in the images are multiples of
    16 bytes, else by the block's own copies (the tail path)."""
    b, t = divmod(u, pl.tiles)
    p0 = t * pl.pt
    n = min(pl.pt, p - p0)
    bulk = (b * p + p0) * row_bytes % 16 == 0 and n * row_bytes % 16 == 0
    return b, p0, n, bulk


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
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("word_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.word_attention.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i,
                                   i, ctypes.c_float, p]
    lib.word_attention.restype = i
    lib.memory_read.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                i, i, i, p]
    lib.memory_read.restype = i
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
    if mask.dtype != torch.int32:     # the serving mask is int32 already
        mask = (mask != 0).to(torch.int32)
    mask = mask.contiguous()
    pl = plan(b, h * w, c, l, images.element_size(), _sm_count(images.device))
    context = torch.empty_like(images)
    attn = torch.empty((b, l, h, w), dtype=torch.float32, device=images.device)
    status = _lib().word_attention(
        _build.DTYPE_CODES[images.dtype], images.data_ptr(), words.data_ptr(),
        mask.data_ptr(), context.data_ptr(), attn.data_ptr(), b, h * w, c, l,
        pl.pt, pl.g, pl.stages, pl.grid, 1.0 / math.sqrt(c),
        torch.cuda.current_stream(images.device).cuda_stream)
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


def _launch_memory_read(images, key, value, mask, gate_w, gate_b
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = images.shape
    l = key.shape[1]
    if images.dtype not in _build.DTYPE_CODES or {key.dtype, value.dtype} \
            != {images.dtype}:
        raise TypeError(f"memory_read_cuda takes fp32 or bf16 images, key "
                        f"and value of one type; got {images.dtype}, "
                        f"{key.dtype}, {value.dtype}")
    if (key.shape != (b, l, c) or value.shape != (b, l, c)
            or mask.shape != (b, l) or gate_w.shape != (2 * c,)
            or gate_b.numel() != 1):
        raise ValueError(f"shapes disagree: images {tuple(images.shape)}, "
                         f"key {tuple(key.shape)}, value "
                         f"{tuple(value.shape)}, mask {tuple(mask.shape)}, "
                         f"gate_w {tuple(gate_w.shape)}, gate_b "
                         f"{tuple(gate_b.shape)}")
    if not 1 <= l <= MAX_WORDS:
        raise ValueError(f"memory_read_cuda takes 1..{MAX_WORDS} words; "
                         f"got {l}")
    v = _build.vector_values(images.dtype)
    chunks = c // v
    if c % v or chunks > 32 or chunks & (chunks - 1):
        raise ValueError(f"memory_read_cuda takes rows of 1, 2, 4 .. 32 "
                         f"16-byte chunks (one a lane); got C={c} in "
                         f"{images.dtype}")
    operands = (("images", images), ("key", key), ("value", value),
                ("mask", mask), ("gate_w", gate_w), ("gate_b", gate_b))
    for name, t in operands:
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on "
                             f"{images.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in operands):
        raise RuntimeError("memory_read_cuda has no backward: call it with "
                           "grad off, or run ops/attention.py::memory_read")
    for name, t in operands[:3]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if mask.dtype != torch.int32:     # the serving mask is int32 already
        mask = (mask != 0).to(torch.int32)
    mask = mask.contiguous()
    gate_w = gate_w.float().contiguous()
    gate_b = gate_b.float().contiguous()
    pl = plan(b, h * w, c, l, images.element_size(), _sm_count(images.device),
              memory=True)
    out = torch.empty((b, h, w, 2 * c), dtype=images.dtype,
                      device=images.device)
    attn = torch.empty((b, l, h, w), dtype=torch.float32, device=images.device)
    status = _lib().memory_read(
        _build.DTYPE_CODES[images.dtype], images.data_ptr(), key.data_ptr(),
        value.data_ptr(), mask.data_ptr(), gate_w.data_ptr(),
        gate_b.data_ptr(), out.data_ptr(), attn.data_ptr(), b, h * w, c, l,
        pl.pt, pl.g, pl.stages, pl.grid,
        torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(status, "memory_read")
    memory_read_cuda.launches += 1
    return out, attn


def memory_read_cuda(images: torch.Tensor, key: torch.Tensor,
                     value: torch.Tensor, mask: torch.Tensor,
                     gate_w: torch.Tensor, gate_b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DM-GAN's fused memory read and response gate: (out (B,H,W,2C),
    attn (B,L,H,W) fp32), as ops/attention.py::memory_read computes them.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    if images.device.type == "cpu":
        return memory_read(images, key, value, mask, gate_w, gate_b)
    if images.device.type != "cuda":
        raise ValueError(f"no kernel for device {images.device}")
    return _launch_memory_read(images, key, value, mask, gate_w, gate_b)


memory_read_cuda.launches = 0   # kernel launches, for tests and smoke runs
