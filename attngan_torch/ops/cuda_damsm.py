"""K4-K6: the DAMSM similarity and its backward as CUDA kernels for Hopper.

Replaces attngan_tpu/ops/pallas_damsm.py: ``damsm_similarity_pallas`` (the
forward, K4 ``_similarity_grid``) with its hand-derived VJP, whose square
case (K5 ``_similarity_grid_bwd_square``, Bi == Bt <= 128) and tiled case
(K6 ``_similarity_grid_bwd_tiled``, rectangular or larger batches) are one
backward kernel here. The kernels are csrc/damsm_similarity.cu; their plain
versions are ops/damsm_similarity.py, which the wrappers run for CPU
tensors and nowhere else.

``damsm_similarity`` keeps the JAX contract: img (Bi, R, D), words
(Bt, L, D), mask (Bt, L) -> sims (Bi, Bt) fp32, for any Bi and Bt. Each
wrapper counts the kernel launches it makes: one per forward call, two per
backward call (the pass over the pairs, then the fixed-order reduction of
its partial sums). The forward and the backward's pass run on the tensor
cores (3xTF32 ``damsm_fwd_tc_kernel`` / ``damsm_bwd_tc_kernel``) where
``takes_tc`` admits the shapes (D a multiple of 32, texts of at most 8
words), on the CUDA cores (``damsm_fwd_kernel`` / ``damsm_bwd_kernel``)
elsewhere: a choice by shape, made here. Each counter also counts, in
``tc_launches``, the calls that took the tensor cores.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Tuple

import torch

from attngan_torch.ops import _build
from attngan_torch.ops.attention import NEG_INF
from attngan_torch.ops.damsm_similarity import (
    similarity_bwd_plain,
    similarity_plain,
)

TILE_FLOATS = 16384   # word rows * D of a text tile: 64 KB of shared memory
MAX_ROWS = 128        # word rows of a text tile
MAX_D = 256
TC_COLS = 32          # the tensor-core pass: a warp owns 32 columns of D,
TC_MAX_L = 8          # a text's words sit in registers,
TC_MAX_ROWS = 64      # and a tile holds at most 4 m16 row tiles
SQUARE_MAX = 128      # the JAX package's square fast path: Bi == Bt <= 128
H100_SMS = 132


def takes_tc(l: int, d: int) -> bool:
    """Whether the forward and the backward's pass run on the tensor cores
    at these dims (csrc/damsm_similarity.cu::takes_tc, with plan's
    tiles)."""
    return d % TC_COLS == 0 and l <= TC_MAX_L


def plan(bi: int, bt: int, l: int, d: int, num_sms: int = H100_SMS,
         slack: float = 1.1) -> Tuple[int, int, int]:
    """(T texts per tile, K tiles, S blocks per image in the backward and
    the tensor-core forward).

    A tile holds whole texts, T * L word rows of D floats, at most
    TILE_FLOATS and MAX_ROWS (TC_MAX_ROWS where the kernels take the
    tensor cores). Those kernels run one block per (image, split) at one
    block per SM (their shared memory); the image's K tiles are dealt over
    S splits (split s takes tiles s, s + S, ...), and S is the smallest
    whose waves x tiles per block is within ``slack`` of the least. The
    backward takes 10%, since each further split adds a d_img partial to
    sum; the forward (slack 1) the least: at 192 x 192 a block per tile,
    2.8% faster than 2 splits on the H100 (PERF.md)."""
    rows = min(TC_MAX_ROWS if takes_tc(l, d) else MAX_ROWS,
               TILE_FLOATS // d)
    if l > rows:
        raise ValueError(f"a text of {l} words does not fit a tile of "
                         f"{rows} rows at D={d}")
    t = rows // l
    k = -(-bt // t)
    cost = {s: -(-bi * s // num_sms) * -(-k // s) for s in range(1, k + 1)}
    best = min(cost.values())
    return t, k, min(s for s, c in cost.items() if c <= slack * best)


class DamsmSimilarity(torch.autograd.Function):
    """sims = ``forward_impl`` (the kernel on the GPU); the gradient of img
    and words is ``backward_impl``'s, the hand-derived VJP."""

    @staticmethod
    def forward(ctx, img, words, mask, gamma1, gamma2,
                forward_impl: Callable, backward_impl: Callable):
        ctx.save_for_backward(img, words, mask)
        ctx.gammas = (gamma1, gamma2)
        ctx.backward_impl = backward_impl
        return forward_impl(img, words, mask, gamma1, gamma2)

    @staticmethod
    def backward(ctx, g):
        img, words, mask = ctx.saved_tensors
        d_img, d_words = ctx.backward_impl(img, words, mask, g.contiguous(),
                                           *ctx.gammas)
        return (d_img if ctx.needs_input_grad[0] else None,
                d_words if ctx.needs_input_grad[1] else None,
                None, None, None, None, None)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("damsm_similarity")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.damsm_similarity_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                         i, f, f, f, p]
    lib.damsm_similarity_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         i, i, i, i, f, f, f, p]
    lib.damsm_similarity_fwd.restype = i
    lib.damsm_similarity_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _checked(img: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
             g: torch.Tensor | None = None) -> torch.Tensor:
    """Raises on what the kernels do not take; returns the int32 mask."""
    bi, r, d = img.shape
    bt, l, _ = words.shape
    if (words.shape[2] != d or mask.shape != (bt, l)
            or g is not None and g.shape != (bi, bt)):
        raise ValueError(f"shapes disagree: img {tuple(img.shape)}, words "
                         f"{tuple(words.shape)}, mask {tuple(mask.shape)}"
                         + ("" if g is None else f", g {tuple(g.shape)}"))
    if not (4 <= d <= MAX_D and d & (d - 1) == 0):
        raise ValueError(f"the kernels take D a power of two in 4..{MAX_D}; "
                         f"got D={d}")
    floats = [("img", img), ("words", words)] + ([] if g is None
                                                 else [("g", g)])
    for name, t in floats + [("mask", mask)]:
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
    for name, t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"the DAMSM kernels take fp32; {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return mask.to(torch.int32).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(img: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
                gamma1: float, gamma2: float,
                splits: int | None = None) -> torch.Tensor:
    """sims; ``splits`` replaces plan's S of the tensor-core form
    (chip_smoke.py times it on other grids)."""
    mask = _checked(img, words, mask)
    bi, r, d = img.shape
    bt, l = mask.shape
    tc = takes_tc(l, d)
    t, _, s = plan(bi, bt, l, d, _num_sms(img.device), slack=1.0)
    sims = torch.empty((bi, bt), dtype=torch.float32, device=img.device)
    status = _lib().damsm_similarity_fwd(
        img.data_ptr(), words.data_ptr(), mask.data_ptr(), sims.data_ptr(),
        bi, bt, r, l, d, t, splits or s, int(tc), 1.0 / math.sqrt(d), gamma1,
        gamma2, _stream(img))
    _build.check(status, "damsm_similarity_fwd")
    damsm_similarity.launches += 1
    damsm_similarity.tc_launches += tc
    return sims


def _launch_bwd(img: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
                g: torch.Tensor, gamma1: float, gamma2: float
                ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(d_img, d_words, whether the pass ran on the tensor cores)."""
    mask = _checked(img, words, mask, g)
    bi, r, d = img.shape
    bt, l = mask.shape
    t, _, s = plan(bi, bt, l, d, _num_sms(img.device))
    tc = takes_tc(l, d)
    f32 = dict(dtype=torch.float32, device=img.device)
    d_img = torch.empty((bi, r, d), **f32)
    d_words = torch.empty((bt, l, d), **f32)
    dw_part = torch.empty((bi, bt, l, d), **f32)
    dctx_part = torch.empty((s, bi, r, d), **f32) if s > 1 else d_img
    status = _lib().damsm_similarity_bwd(
        img.data_ptr(), words.data_ptr(), mask.data_ptr(), g.data_ptr(),
        d_img.data_ptr(), d_words.data_ptr(), dctx_part.data_ptr(),
        dw_part.data_ptr(), bi, bt, r, l, d, t, s, int(tc),
        1.0 / math.sqrt(d), gamma1, gamma2, _stream(img))
    _build.check(status, "damsm_similarity_bwd")
    return d_img, d_words, tc


def _backward(counter, img, words, mask, g, gamma1, gamma2):
    if img.device.type == "cpu":
        return similarity_bwd_plain(img, words, mask, g, gamma1, gamma2)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    d_img, d_words, tc = _launch_bwd(img, words, mask, g, gamma1, gamma2)
    counter.launches += 2
    counter.tc_launches += tc
    return d_img, d_words


def damsm_similarity_bwd_square(img, words, mask, g, gamma1=4.0, gamma2=5.0):
    """The K5 case, Bi == Bt <= 128: (d_img, d_words) for cotangent g."""
    if not img.shape[0] == words.shape[0] <= SQUARE_MAX:
        raise ValueError(f"the square case takes Bi == Bt <= {SQUARE_MAX}; "
                         f"got {img.shape[0]} x {words.shape[0]}")
    return _backward(damsm_similarity_bwd_square, img, words, mask, g,
                     gamma1, gamma2)


def damsm_similarity_bwd_tiled(img, words, mask, g, gamma1=4.0, gamma2=5.0):
    """The K6 case, any Bi and Bt: (d_img, d_words) for cotangent g."""
    return _backward(damsm_similarity_bwd_tiled, img, words, mask, g,
                     gamma1, gamma2)


def damsm_similarity_bwd(img, words, mask, g, gamma1=4.0, gamma2=5.0):
    """The VJP, dispatched as the JAX package dispatches K5 and K6
    (attngan_tpu/ops/pallas_damsm.py::_damsm_similarity_bwd): square
    batches of at most 128 take the K5 case. Its further limit on the
    square case's VMEM footprint has no counterpart here (it holds at
    L = 8, R = 289 up to 128 texts)."""
    square = img.shape[0] == words.shape[0] <= SQUARE_MAX
    fn = damsm_similarity_bwd_square if square else damsm_similarity_bwd_tiled
    return fn(img, words, mask, g, gamma1, gamma2)


def damsm_similarity(img: torch.Tensor, words: torch.Tensor,
                     mask: torch.Tensor, gamma1: float = 4.0,
                     gamma2: float = 5.0) -> torch.Tensor:
    """sims[j, i] = Eq. 10 similarity of (image j, text i); (Bi, Bt) fp32.

    A CUDA tensor launches the kernels (or raises); a CPU tensor runs the
    plain versions, through the same autograd.Function."""
    if img.device.type == "cpu":
        forward_impl = similarity_plain
    elif img.device.type == "cuda":
        forward_impl = _launch_fwd
    else:
        raise ValueError(f"no kernel for device {img.device}")
    return DamsmSimilarity.apply(img, words, mask, float(gamma1),
                                 float(gamma2), forward_impl,
                                 damsm_similarity_bwd)


def words_loss_fused(img_features, words_emb, labels, word_mask, class_ids,
                     gamma1=4.0, gamma2=5.0, gamma3=10.0, wlambda=5.0):
    """The words loss through the kernels (no attention maps), as
    attngan_tpu/ops/pallas_damsm.py::words_loss_pallas."""
    from attngan_torch.losses.damsm import _class_mask, _symmetric_ce

    sims = damsm_similarity(img_features, words_emb, word_mask, gamma1,
                            gamma2) * gamma3
    if class_ids is not None:
        sims = sims.masked_fill(_class_mask(class_ids), NEG_INF)
    return _symmetric_ce(sims, labels) * wlambda


# kernel launches, for tests and smoke runs
damsm_similarity.launches = 0
damsm_similarity.tc_launches = 0
damsm_similarity_bwd_square.launches = 0
damsm_similarity_bwd_tiled.launches = 0
damsm_similarity_bwd_square.tc_launches = 0
damsm_similarity_bwd_tiled.tc_launches = 0
