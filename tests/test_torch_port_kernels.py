"""The plain versions of the port's K1 and K2 Hopper kernels against the
three JAX Pallas kernels they replace (K2 stands for both of JAX's UpBlock
kernels).

On the CPU the Pallas kernels run in interpret mode, as the JAX package's
own tests run them, and each port wrapper takes its plain version because
its tensors lie on the CPU. The kernels themselves are held against these
plain versions on the card by tests/test_torch_cuda_kernels.py and
chip_smoke.py.

Tolerances: fp32 against fp32 at 1e-5 absolute (same arithmetic, other
summation order; observed ~1e-7). bf16 outputs at 2e-2 absolute on values
of order 1: one bf16 rounding step (2^-8 relative) that an fp32 difference
in summation order can flip, with room for values up to ~4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attngan_tpu.ops.attention import word_attention as jax_word_attention
from attngan_tpu.ops.pallas_attention import word_attention_pallas
from attngan_tpu.ops.pallas_upblock import upblock_fused_eval as jax_upblock
from attngan_tpu.ops.pallas_upblock_packed import upblock_pallas_packed

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.attention import word_attention
from attngan_torch.ops.cuda_attention import WordAttention, word_attention_cuda
from attngan_torch.ops.cuda_upblock import (
    upblock_fused_eval,
    upblock_fused_eval_cuda,
)

FP32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _attention_case(rng, b=3, h=8, w=6, c=8, l=5):
    images = rng.standard_normal((b, h, w, c)).astype(np.float32)
    words = rng.standard_normal((b, l, c)).astype(np.float32)
    lengths = np.array([l, 2, 1])[:b]                  # ragged: pads masked
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.int32)
    return images, words, mask


def _upblock_case(rng, b, h, w, ci, co):
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, ci, 2 * co)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 2 * co).astype(np.float32)
    bias = (rng.standard_normal(2 * co) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(2 * co) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 2 * co).astype(np.float32)
    bn_k = scale / np.sqrt(var + 1e-5)
    return x, kernel, (scale, bias, mean, var), bn_k, bias - mean * bn_k


def _oihw(kernel):
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- K1: word attention ---------------------------------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_word_attention_plain_matches_jax(rng, impl):
    images, words, mask = _attention_case(rng)
    if impl == "jnp":
        want_ctx, want_attn = jax_word_attention(images, words, mask)
    else:
        want_ctx, want_attn = word_attention_pallas(images, words, mask,
                                                    block_p=16, interpret=True)
    got_ctx, got_attn = word_attention(_t(images), _t(words), _t(mask))
    assert got_attn.shape == (3, 5, 8, 6) and got_attn.dtype == torch.float32
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                               atol=FP32_ATOL)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               atol=FP32_ATOL)
    assert float(got_attn[2, 1:].abs().max()) == 0.0   # padded words unseen


def test_word_attention_wrapper_takes_plain_version_on_cpu(rng):
    images, words, mask = _attention_case(rng)
    before = word_attention_cuda.launches
    got = word_attention_cuda(_t(images), _t(words), _t(mask))
    want = word_attention(_t(images), _t(words), _t(mask))
    assert word_attention_cuda.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_word_attention_gradient_matches_jax_vjp(rng):
    images, words, mask = _attention_case(rng)
    d_ctx = rng.standard_normal(images.shape).astype(np.float32)
    d_attn = rng.standard_normal((3, 5, 8, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda im, wd: word_attention_pallas(
        im, wd, mask, block_p=16, interpret=True), jnp.asarray(images),
        jnp.asarray(words))
    want_di, want_dw = vjp((jnp.asarray(d_ctx), jnp.asarray(d_attn)))

    im = _t(images).requires_grad_()
    wd = _t(words).requires_grad_()
    # the autograd.Function the GPU path uses, with the plain forward
    ctx, attn = WordAttention.apply(im, wd, _t(mask), word_attention)
    torch.autograd.backward((ctx, attn), (_t(d_ctx), _t(d_attn)))
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(want_di),
                               atol=1e-4)
    np.testing.assert_allclose(wd.grad.numpy(), np.asarray(want_dw),
                               atol=1e-4)


# --- K2: fused eval UpBlock -------------------------------------------------

@pytest.mark.parametrize("b,h,w,ci,co", [(2, 8, 8, 16, 8), (1, 6, 10, 8, 4)])
def test_upblock_plain_matches_pallas_interpret(rng, b, h, w, ci, co):
    x, kernel, bn, bn_k, bn_b = _upblock_case(rng, b, h, w, ci, co)
    want = jax_upblock(x, kernel, *bn, interpret=True)
    got = upblock_fused_eval(_t(x), _oihw(kernel), _t(bn_k), _t(bn_b))
    assert got.shape == (b, 2 * h, 2 * w, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_upblock_plain_bf16_matches_pallas_interpret(rng):
    x, kernel, bn, bn_k, bn_b = _upblock_case(rng, 2, 8, 8, 16, 8)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_upblock(xb, kernel, *bn, interpret=True)
    got = upblock_fused_eval(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        _oihw(kernel), _t(bn_k), _t(bn_b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL)


def test_upblock_wrappers_take_plain_version_on_cpu(rng):
    x, kernel, _, bn_k, bn_b = _upblock_case(rng, 1, 8, 8, 64, 32)
    args = (_t(x), _oihw(kernel), _t(bn_k), _t(bn_b))
    want = upblock_fused_eval(*args)
    before = (upblock_fused_eval_cuda.launches,
              upblock_fused_eval_cuda.resident_launches)
    assert torch.equal(upblock_fused_eval_cuda(*args), want)
    assert (upblock_fused_eval_cuda.launches,
            upblock_fused_eval_cuda.resident_launches) == before


# --- JAX's Ci=64 -> Co=32 lane-packed kernel: K2's route on Hopper ---------

@pytest.mark.parametrize("b,h,w", [(2, 8, 8), (1, 4, 12)])
def test_packed_plain_matches_pallas_packed_interpret(rng, b, h, w):
    x, kernel, _, bn_k, bn_b = _upblock_case(rng, b, h, w, 64, 32)
    want = upblock_pallas_packed(x, kernel, bn_k, bn_b, interpret=True)
    got = upblock_fused_eval_cuda(_t(x), _oihw(kernel), _t(bn_k), _t(bn_b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)
