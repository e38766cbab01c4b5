"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor tests/conftest.py's fixtures, so that
it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: fp32 at 1e-4 absolute (the same arithmetic in another summation
order, TF32 off). bf16 outputs at 1e-2 absolute plus 2^-7 relative: one
bf16 rounding step that a difference in fp32 summation order can flip.
Attention maps are fp32 in both versions: 1e-5.
"""

import pytest
import torch

from attngan_torch.ops.attention import word_attention
from attngan_torch.ops.cuda_attention import word_attention_cuda
from attngan_torch.ops.cuda_upblock import (
    upblock_fused_eval,
    upblock_fused_eval_cuda,
)
from attngan_torch.ops.cuda_upblock_packed import upblock_fused_eval_packed_cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,l", [(3, 33, 7, 32, 5), (2, 64, 64, 32, 13),
                                       (1, 5, 5, 8, 32)])
def test_word_attention_kernel_matches_plain(cuda, dtype, b, h, w, c, l):
    images = _randn(cuda, b, h, w, c).to(dtype)
    words = _randn(cuda, b, l, c).to(dtype)
    lengths = torch.randint(1, l + 1, (b,), generator=cuda, device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).int()
    before = word_attention_cuda.launches
    ctx, attn = word_attention_cuda(images, words, mask)
    torch.cuda.synchronize()
    assert word_attention_cuda.launches == before + 1
    want_ctx, want_attn = word_attention(images, words, mask)
    assert ctx.dtype == dtype and attn.shape == (b, l, h, w)
    torch.testing.assert_close(ctx.float(), want_ctx.float(), **TOL[dtype])
    torch.testing.assert_close(attn, want_attn, atol=1e-5, rtol=0.0)


def test_word_attention_gradient_recomputes_through_plain(cuda):
    images = _randn(cuda, 2, 8, 8, 32).requires_grad_()
    words = _randn(cuda, 2, 5, 32).requires_grad_()
    mask = torch.ones(2, 5, dtype=torch.int32, device="cuda")
    ctx, attn = word_attention_cuda(images, words, mask)
    (ctx.sum() + attn.square().sum()).backward()
    im2, wd2 = images.detach().requires_grad_(), words.detach().requires_grad_()
    c2, a2 = word_attention(im2, wd2, mask)
    (c2.sum() + a2.square().sum()).backward()
    torch.testing.assert_close(images.grad, im2.grad, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(words.grad, wd2.grad, atol=1e-4, rtol=0.0)


def test_word_attention_rejects_what_the_kernel_does_not_take(cuda):
    images = _randn(cuda, 1, 4, 4, 32)
    with pytest.raises(ValueError, match="words"):
        word_attention_cuda(images, _randn(cuda, 1, 33, 32),
                            torch.ones(1, 33, device="cuda"))
    with pytest.raises(TypeError):
        word_attention_cuda(images.half(), _randn(cuda, 1, 5, 32).half(),
                            torch.ones(1, 5, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        word_attention_cuda(images.transpose(1, 2), _randn(cuda, 1, 5, 32),
                            torch.ones(1, 5, device="cuda"))


def _upblock_args(gen, b, h, w, ci, co, dtype):
    return (_randn(gen, b, h, w, ci).to(dtype),
            _randn(gen, 2 * co, ci, 3, 3, scale=(9 * ci) ** -0.5),
            torch.rand(2 * co, generator=gen, device="cuda") + 0.5,
            _randn(gen, 2 * co, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ci,co", [(2, 20, 36, 64, 32),
                                         (1, 64, 64, 16, 8),
                                         (1, 9, 17, 128, 64),
                                         (1, 8, 16, 48, 24)])
def test_upblock_kernel_matches_plain(cuda, dtype, b, h, w, ci, co):
    args = _upblock_args(cuda, b, h, w, ci, co, dtype)
    before = upblock_fused_eval_cuda.launches
    got = upblock_fused_eval_cuda(*args)
    torch.cuda.synchronize()
    assert upblock_fused_eval_cuda.launches == before + 1
    assert got.shape == (b, 2 * h, 2 * w, co) and got.dtype == dtype
    torch.testing.assert_close(got.float(), upblock_fused_eval(*args).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(2, 20, 36), (1, 64, 64)])
def test_packed_kernel_matches_plain(cuda, dtype, b, h, w):
    args = _upblock_args(cuda, b, h, w, 64, 32, dtype)
    before = upblock_fused_eval_packed_cuda.launches
    got = upblock_fused_eval_packed_cuda(*args)
    torch.cuda.synchronize()
    assert upblock_fused_eval_packed_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), upblock_fused_eval(*args).float(),
                               **TOL[dtype])


def test_upblock_kernels_reject_what_they_do_not_take(cuda):
    x, weight, k, b = _upblock_args(cuda, 1, 8, 8, 32, 32, torch.float32)
    with pytest.raises(ValueError, match="Ci=64"):
        upblock_fused_eval_packed_cuda(x, weight, k, b)
    x, weight, k, b = _upblock_args(cuda, 1, 8, 8, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        upblock_fused_eval_cuda(x, weight, k, b)
    x, weight, k, b = _upblock_args(cuda, 1, 8, 8, 24, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="do not fit"):
        upblock_fused_eval_cuda(x, weight, k, b)
