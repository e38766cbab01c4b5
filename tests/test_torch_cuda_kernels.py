"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor tests/conftest.py's fixtures, so that
it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: fp32 at 1e-4 absolute (the same arithmetic in another summation
order, TF32 off). bf16 outputs at 1e-2 absolute plus 2^-7 relative: one
bf16 rounding step that a difference in fp32 summation order can flip.
The bf16 UpBlock at Ci=64 -> Co=32 takes the resident-weight wgmma
kernel, counted by ``upblock_fused_eval_cuda.resident_launches``, and at
DM-GAN's Ci=128 -> Co=64 the cluster kernel, counted by
``cluster_launches``. Both, and word attention (K1), give the same bits on
a second launch.
Attention maps are fp32 in both versions: 1e-5. The DAMSM similarity
(fp32 end to end): sims within 1e-4 relative and 1e-5 absolute; gradients
within 1e-3 relative plus 1e-5 of the largest entry (the kernel forms the
region-softmax row term as d_v.v, the plain version as sum_r d_a2 a2, and
both sum over 64-192 texts and 289 regions in other orders); scores of
~1e3: 5e-3 relative, 5e-4 absolute, as tests/test_pallas.py allows. The
forward and the backward's pass run on the tensor cores in 3xTF32 at D a
multiple of 32 and texts of at most 8 words (``tc_launches``) and are held
to the same tolerances (tests/test_torch_port_damsm_tf32.py states their
error on the CPU).

The data path and the loops: the image pyramid on the card against the
CPU, and both loops at tiny dims with exact launch counts.

The pretrain options: one cached, one superbatch (K = 2) and one
train-mode trunk BN step in fp32 on the card (the tiny encoder, the BN step
on the Inception trunk at 64^2, batch 2), with exact K4 / K5 launches,
against the CPU: metrics to 1e-3 relative (the BN step's trunk is 94 convs,
cuDNN against the CPU's), the moved statistics to 1e-3 relative plus 1e-4,
the trained parameters to 1e-4 in all but 1% of each tensor's elements,
which may differ by 2 lr a step (Adam's first steps move an element by
about +-lr, one way on each device where its two gradients straddle 0).

The GAN step's shapes and modes: K4 and K5 at 16 x 16 with 5 words (the
G-step's DAMSM coupling); K1's gradient under autograd at batch 16 in bf16
(the train-mode generator), which must equal the plain path's; the trunk's
average pool's gradient for channels_last maps against the CPU's; one fp32
GAN step at tiny dims on the card against the CPU, tolerances in its
docstring.

The timing helper: ``utils.timing.device_timeit`` stops its clock after
the device's work, against CUDA events around the same loop.
"""

import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.attention import word_attention
from attngan_torch.ops.cuda_attention import word_attention_cuda
from attngan_torch.ops.cuda_upblock import (
    upblock_fused_eval,
    upblock_fused_eval_cuda,
)
from attngan_torch.ops.cuda_damsm import (
    _launch_fwd,
    damsm_similarity,
    damsm_similarity_bwd,
    damsm_similarity_bwd_square,
    damsm_similarity_bwd_tiled,
    plan,
)
from attngan_torch.ops.damsm_similarity import (
    similarity_bwd_plain,
    similarity_plain,
)

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
@pytest.mark.parametrize("b,h,w,c,l", [
    (3, 33, 7, 32, 5), (2, 64, 64, 32, 13), (1, 5, 5, 8, 32),
    (64, 64, 64, 32, 5),      # the serving path's gen2 call
    (64, 128, 128, 32, 5),    # and its gen3 call
    (3, 5, 5, 4, 5),          # C = 4: 8-byte bf16 rows, the tail path
    (2, 21, 11, 12, 32),      # C % 8 == 4, 32 words, odd P
])
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
    again = word_attention_cuda(images, words, mask)       # same bits
    assert torch.equal(again[0], ctx) and torch.equal(again[1], attn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_word_attention_kernel_float_and_empty_masks(cuda, dtype):
    b, h, w, c, l = 4, 16, 16, 32, 5
    images = _randn(cuda, b, h, w, c).to(dtype)
    words = _randn(cuda, b, l, c).to(dtype)
    real = torch.arange(l, device="cuda")[None] < torch.tensor(
        [5, 2, 1, 0], device="cuda")[:, None]    # image 3: every word masked
    for mask in (real.float() * 0.5, real, real.int()):
        ctx, attn = word_attention_cuda(images, words, mask)
        want_ctx, want_attn = word_attention(images, words, mask)
        torch.testing.assert_close(ctx.float(), want_ctx.float(),
                                   **TOL[dtype])
        torch.testing.assert_close(attn, want_attn, atol=1e-5, rtol=0.0)
        assert float(attn[2, 1:].abs().max()) == 0.0
        torch.testing.assert_close(attn[3], torch.full_like(attn[3], 0.2),
                                   atol=1e-6, rtol=0.0)


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


@pytest.mark.parametrize("b,h,w,ci,co", [
    (2, 64, 64, 64, 32),      # fewer units (128) than blocks
    (8, 128, 128, 64, 32),    # the persistent loop wraps
    (2, 20, 36, 64, 32),      # ragged units in both directions
    (64, 64, 64, 64, 32),     # the serving path's gen2 call
    (3, 17, 40, 64, 32),      # odd batch, one unit row of 1 source row
])
def test_upblock_resident_kernel_matches_plain(cuda, b, h, w, ci, co):
    args = _upblock_args(cuda, b, h, w, ci, co, torch.bfloat16)
    before = (upblock_fused_eval_cuda.launches,
              upblock_fused_eval_cuda.resident_launches)
    got = upblock_fused_eval_cuda(*args)
    torch.cuda.synchronize()
    assert (upblock_fused_eval_cuda.launches,
            upblock_fused_eval_cuda.resident_launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert got.shape == (b, 2 * h, 2 * w, co) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), upblock_fused_eval(*args).float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(upblock_fused_eval_cuda(*args), got)   # same bits


@pytest.mark.parametrize("b,h,w,ci,co", [
    (64, 64, 64, 128, 64),    # DM-GAN's first refinement UpBlock at 64
    (8, 128, 128, 128, 64),   # the second's shape: the clusters' loop wraps
    (2, 20, 36, 128, 64),     # ragged units in both directions
    (3, 17, 40, 128, 64),     # odd batch, one unit row of 1 source row
    (1, 8, 16, 128, 64),      # one unit: one cluster, one warpgroup busy
])
def test_upblock_cluster_kernel_matches_plain(cuda, b, h, w, ci, co):
    args = _upblock_args(cuda, b, h, w, ci, co, torch.bfloat16)
    k2 = upblock_fused_eval_cuda
    before = (k2.launches, k2.resident_launches, k2.cluster_launches)
    got = k2(*args)
    torch.cuda.synchronize()
    assert (k2.launches, k2.resident_launches, k2.cluster_launches) == (
        before[0] + 1, before[1], before[2] + 1)
    assert got.shape == (b, 2 * h, 2 * w, co) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), upblock_fused_eval(*args).float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(k2(*args), got)   # same bits


@pytest.mark.parametrize("dtype,ci,co", [(torch.bfloat16, 32, 16),
                                         (torch.bfloat16, 16, 8),
                                         (torch.float32, 64, 32)])
def test_upblock_other_dims_keep_the_warp_level_kernel(cuda, dtype, ci, co):
    args = _upblock_args(cuda, 1, 9, 17, ci, co, dtype)
    k2 = upblock_fused_eval_cuda
    before = (k2.launches, k2.resident_launches, k2.cluster_launches)
    got = k2(*args)
    torch.cuda.synchronize()
    assert (k2.launches, k2.resident_launches, k2.cluster_launches) == (
        before[0] + 1, before[1], before[2])
    torch.testing.assert_close(got.float(), upblock_fused_eval(*args).float(),
                               **TOL[dtype])


def test_upblock_kernels_reject_what_they_do_not_take(cuda):
    x, weight, k, b = _upblock_args(cuda, 1, 8, 8, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        upblock_fused_eval_cuda(x, weight, k, b)
    x, weight, k, b = _upblock_args(cuda, 1, 8, 8, 24, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="do not fit"):
        upblock_fused_eval_cuda(x, weight, k, b)


def _damsm_args(gen, bi, bt, l, r, d, extreme=False):
    img = _randn(gen, bi, r, d)
    words = _randn(gen, bt, l, d)
    if extreme:
        words[0] *= 250.0        # text 0's scores ~ +-1e3, the rest O(1)
    lengths = torch.randint(1, l + 1, (bt,), generator=gen, device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).int()
    return img, words, mask, _randn(gen, bi, bt)


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=1e-5 * float(b.abs().max()))


DAMSM_SHAPES = [(64, 64, 8, 289, 256), (16, 64, 8, 289, 256),
                (5, 7, 3, 20, 32), (3, 130, 5, 17, 16), (2, 3, 8, 33, 4)]


@pytest.mark.parametrize("bi,bt,l,r,d", DAMSM_SHAPES)
def test_damsm_similarity_kernels_match_plain(cuda, bi, bt, l, r, d):
    img, words, mask, g = _damsm_args(cuda, bi, bt, l, r, d)
    before = damsm_similarity.launches
    sims = damsm_similarity(img, words, mask)
    torch.cuda.synchronize()
    assert damsm_similarity.launches == before + 1
    torch.testing.assert_close(sims, similarity_plain(img, words, mask),
                               rtol=1e-4, atol=1e-5)
    square = bi == bt <= 128
    counter = (damsm_similarity_bwd_square if square
               else damsm_similarity_bwd_tiled)
    before = counter.launches
    got = damsm_similarity_bwd(img, words, mask, g)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    _assert_grads_close(got, similarity_bwd_plain(img, words, mask, g))
    again = damsm_similarity_bwd(img, words, mask, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # same bits


def _counts(counter):
    return counter.launches, counter.tc_launches


TC_SHAPES = [
    (64, 64, 8, 289, 256),     # K4 and K5 on the pretrain step
    (64, 64, 2, 289, 256),     # ... on 2-word synthetic captions
    (192, 192, 8, 289, 256),   # K4 and K6 on the B=192 step
    (16, 64, 8, 289, 256),     # a data-parallel shard's rows
    (4, 6, 8, 33, 256),        # ragged R: 1 region in the last chunk
    (3, 5, 8, 17, 256),        # R < one chunk, n8 tiles skipped
    (4, 9, 3, 40, 256),        # L=3: 63-row tiles, padded to 64
    (5, 30, 5, 50, 128),       # L=5 at D=128: 60-row tiles, three of them
    (3, 4, 5, 20, 32),         # D=32: one warp per row band
]


@pytest.mark.parametrize("bi,bt,l,r,d", TC_SHAPES)
def test_damsm_backward_tensor_core_pass(cuda, bi, bt, l, r, d):
    img, words, mask, g = _damsm_args(cuda, bi, bt, l, r, d)
    counter = (damsm_similarity_bwd_square if bi == bt <= 128
               else damsm_similarity_bwd_tiled)
    before = _counts(counter)
    got = damsm_similarity_bwd(img, words, mask, g)
    torch.cuda.synchronize()
    assert _counts(counter) == (before[0] + 2, before[1] + 1)
    _assert_grads_close(got, similarity_bwd_plain(img, words, mask, g))
    again = damsm_similarity_bwd(img, words, mask, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # same bits


def test_damsm_backward_tensor_cores_extreme_and_empty_text(cuda):
    img, words, mask, g = _damsm_args(cuda, 64, 64, 8, 289, 256,
                                      extreme=True)
    mask[5] = 0                                  # a text with no real word
    before = _counts(damsm_similarity_bwd_square)
    got = damsm_similarity_bwd(img, words, mask, g)
    torch.cuda.synchronize()
    assert _counts(damsm_similarity_bwd_square) == (before[0] + 2,
                                                    before[1] + 1)
    assert float(got[1][5].abs().max()) == 0.0
    for a, b in zip(got, similarity_bwd_plain(img, words, mask, g)):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4)


def test_damsm_backward_small_d_keeps_the_cuda_core_pass(cuda):
    img, words, mask, g = _damsm_args(cuda, 2, 3, 8, 33, 4)
    before = _counts(damsm_similarity_bwd_tiled)
    got = damsm_similarity_bwd(img, words, mask, g)
    torch.cuda.synchronize()
    assert _counts(damsm_similarity_bwd_tiled) == (before[0] + 2, before[1])
    _assert_grads_close(got, similarity_bwd_plain(img, words, mask, g))


def test_damsm_kernels_extreme_magnitudes(cuda):
    img, words, mask, g = _damsm_args(cuda, 4, 4, 3, 9, 16, extreme=True)
    torch.testing.assert_close(damsm_similarity(img, words, mask),
                               similarity_plain(img, words, mask),
                               rtol=5e-3, atol=5e-4)
    for a, b in zip(damsm_similarity_bwd(img, words, mask, g),
                    similarity_bwd_plain(img, words, mask, g)):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4)


def test_damsm_autograd_runs_the_backward_kernel(cuda):
    img, words, mask, g = _damsm_args(cuda, 6, 6, 4, 25, 32)
    mask[2] = 0                                  # a text with no word
    im, wd = img.clone().requires_grad_(), words.clone().requires_grad_()
    (damsm_similarity(im, wd, mask) * g).sum().backward()
    want = similarity_bwd_plain(img, words, mask, g)
    assert float(wd.grad[2].abs().max()) == 0.0
    _assert_grads_close((im.grad, wd.grad), want)


def test_damsm_kernels_reject_what_they_do_not_take(cuda):
    img, words, mask, g = _damsm_args(cuda, 2, 2, 4, 9, 32)
    with pytest.raises(TypeError):
        damsm_similarity(img.bfloat16(), words.bfloat16(), mask)
    with pytest.raises(ValueError, match="power of two"):
        damsm_similarity(img[..., :24].contiguous(),
                         words[..., :24].contiguous(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        damsm_similarity(img.transpose(1, 2).contiguous().transpose(1, 2),
                         words, mask)


@pytest.mark.parametrize("bi,bt,l,r,d", TC_SHAPES)
def test_damsm_forward_tensor_core_form(cuda, bi, bt, l, r, d):
    img, words, mask, _ = _damsm_args(cuda, bi, bt, l, r, d)
    before = _counts(damsm_similarity)
    sims = damsm_similarity(img, words, mask)
    torch.cuda.synchronize()
    assert _counts(damsm_similarity) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(sims, similarity_plain(img, words, mask),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(sims, damsm_similarity(img, words, mask))  # same bits


def test_damsm_forward_tensor_cores_extreme_and_empty_text(cuda):
    img, words, mask, _ = _damsm_args(cuda, 64, 64, 8, 289, 256,
                                      extreme=True)
    mask[5] = 0                                  # a text with no real word
    before = _counts(damsm_similarity)
    sims = damsm_similarity(img, words, mask)
    torch.cuda.synchronize()
    assert _counts(damsm_similarity) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isneginf(sims[:, 5]).all())
    torch.testing.assert_close(sims, similarity_plain(img, words, mask),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("l,d", [(8, 4), (8, 16), (12, 32)])
def test_damsm_forward_other_shapes_keep_the_cuda_core_kernel(cuda, l, d):
    img, words, mask, _ = _damsm_args(cuda, 2, 3, l, 33, d)
    before = _counts(damsm_similarity)
    sims = damsm_similarity(img, words, mask)
    torch.cuda.synchronize()
    assert _counts(damsm_similarity) == (before[0] + 1, before[1])
    torch.testing.assert_close(sims, similarity_plain(img, words, mask),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bi,bt", [(64, 64), (192, 192), (3, 61)])
def test_damsm_forward_grids_give_the_same_bits(cuda, bi, bt):
    """A block per image, plan's S blocks and a block per text tile compute
    each (image, tile) with the same instructions."""
    img, words, mask, _ = _damsm_args(cuda, bi, bt, 8, 289, 256)
    _, k, s = plan(bi, bt, 8, 256)
    want = _launch_fwd(img, words, mask, 4.0, 5.0, splits=s)
    torch.testing.assert_close(want, similarity_plain(img, words, mask),
                               rtol=1e-4, atol=1e-5)
    for n in (1, k):
        assert torch.equal(_launch_fwd(img, words, mask, 4.0, 5.0, splits=n),
                           want)


# ---- the GAN step's shapes and modes

def test_damsm_kernels_at_the_gan_coupling_shape(cuda):
    """K4 and K5 in the G-step's DAMSM coupling: 16 x 16, 5 words (tiles of
    12 texts, 60 word rows, the second tile of 4), R = 289, D = 256."""
    img, words, mask, g = _damsm_args(cuda, 16, 16, 5, 289, 256)
    mask[3] = 0                                  # a text with no real word
    fwd, bwd = _counts(damsm_similarity), _counts(damsm_similarity_bwd_square)
    sims = damsm_similarity(img, words, mask)
    got = damsm_similarity_bwd(img, words, mask, g)
    torch.cuda.synchronize()
    assert _counts(damsm_similarity) == (fwd[0] + 1, fwd[1] + 1)
    assert _counts(damsm_similarity_bwd_square) == (bwd[0] + 2, bwd[1] + 1)
    want = similarity_plain(img, words, mask)
    assert bool(torch.isneginf(sims[:, 3]).all())
    torch.testing.assert_close(sims, want, rtol=1e-4, atol=1e-5)
    _assert_grads_close(got, similarity_bwd_plain(img, words, mask, g))
    assert float(got[1][3].abs().max()) == 0.0


@pytest.mark.parametrize("hw", [64, 128])
def test_word_attention_gradient_at_the_gan_shapes_in_bf16(cuda, hw):
    """K1 under autograd at the train-mode generator's shapes (batch 16,
    gf = 32, 5 words, bf16): the kernel's forward, the plain version's
    recompute in the backward, with d_attn zero (the maps do not enter the
    loss); the outputs and the gradient equal the plain path's."""
    b, c, l = 16, 32, 5
    images = _randn(cuda, b, hw, hw, c).to(torch.bfloat16)
    words = _randn(cuda, b, l, c).to(torch.bfloat16)
    lengths = torch.randint(1, l + 1, (b,), generator=cuda, device="cuda")
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).int()
    d_ctx = _randn(cuda, b, hw, hw, c).to(torch.bfloat16)
    outs, grads = [], []
    for fn in (word_attention_cuda, word_attention):
        im = images.clone().requires_grad_()
        wd = words.clone().requires_grad_()
        before = word_attention_cuda.launches
        ctx, attn = fn(im, wd, mask)
        (ctx.float() * d_ctx.float()).sum().backward()
        torch.cuda.synchronize()
        assert word_attention_cuda.launches == before + (
            fn is word_attention_cuda)          # the backward launches none
        outs.append((ctx.detach(), attn.detach()))
        grads.append((im.grad, wd.grad))
    (ctx, attn), (want_ctx, want_attn) = outs
    assert ctx.dtype == torch.bfloat16 and attn.dtype == torch.float32
    torch.testing.assert_close(ctx.float(), want_ctx.float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(attn, want_attn, atol=1e-5, rtol=0.0)
    for a, b_ in zip(*grads):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b_.float(),
                                   **TOL[torch.bfloat16])


def test_gan_step_on_the_card_matches_the_cpu(cuda):
    """One fp32 GAN step at tiny dims (3 stages, the tiny image encoder) on
    the card, with K1, K4 and K5, against the port's CPU run from the same
    seeded weights, noise and eps: metrics to 1e-4 relative, gradients to
    1e-3 relative plus 1e-3 of the largest entry, parameters and BN
    statistics to 1e-4 (an element whose two gradients lie on two sides of
    0 may differ by 2 lr more: Adam moves it by about +-lr either way)."""
    import numpy as np

    from attngan_torch.core.config import GanConfig
    from attngan_torch.train.gan_trainer import GanTrainer

    cfg = GanConfig(gf_dim=4, df_dim=4, emb_dim=16, cond_dim=4, z_dim=4,
                    seq_len=4, image_encoder="tiny", compute_dtype="")
    rng = np.random.default_rng(0)
    b = 3
    batch = {"tokens": rng.integers(0, 30, (b, 4)),
             "lengths": np.array([4, 2, 3]), "class_ids": np.array([0, 1, 0]),
             **{f"img{r}": np.tanh(rng.standard_normal((b, r, r, 3))
                                   ).astype(np.float32)
                for r in cfg.resolutions}}
    noise = torch.from_numpy(rng.standard_normal((b, 4), dtype=np.float32))
    eps = torch.from_numpy(rng.standard_normal((b, 4), dtype=np.float32))
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = GanTrainer(cfg, 30, device=dev)
        state = trainer.init_state(seed=3)
        k1 = word_attention_cuda.launches
        state, m = trainer.train_step(state, batch, noise=noise, eps=eps)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert word_attention_cuda.launches == k1 + 2
        modules = {"gen": state.gen, **state.discs}
        runs[dev] = ({k: float(v) for k, v in m.items()},
                     {f"{w}.{k}": (p.detach().cpu(), p.grad.cpu())
                      for w, mod in modules.items()
                      for k, p in mod.named_parameters()},
                     {f"{w}.{k}": v.cpu() for w, mod in modules.items()
                      for k, v in mod.named_buffers()})
    (m_gpu, p_gpu, s_gpu), (m_cpu, p_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-4 * abs(v), (k, m_gpu[k], v)
    for k, (p, g) in p_cpu.items():
        p2, g2 = p_gpu[k]
        torch.testing.assert_close(g2, g, rtol=1e-3,
                                   atol=1e-3 * float(g.abs().max()))
        allow = 2 * cfg.gen_lr * (torch.sign(g2) != torch.sign(g))
        assert float(((p2 - p).abs() - allow).max()) <= 1e-4, k
    for k, v in s_cpu.items():
        torch.testing.assert_close(s_gpu[k], v, rtol=0.0, atol=1e-4)


def test_trunk_avg_pool_gradient_in_channels_last(cuda):
    """The Inception trunk's 3x3 average pool, which the GAN step
    differentiates through, gives the CPU's gradient for the trunk's
    channels_last maps on the card (F.avg_pool2d's CUDA backward does not
    for a channels_last input: models/cnn_encoder.py::_avg_pool3x3)."""
    from attngan_torch.models.cnn_encoder import _avg_pool3x3

    x = _randn(cuda, 4, 192, 35, 35).to(memory_format=torch.channels_last)
    w = _randn(cuda, 4, 192, 35, 35)
    grads = []
    for dev in ("cuda", "cpu"):
        xi = x.to(dev).clone().requires_grad_()
        y = _avg_pool3x3(xi)
        torch.testing.assert_close(
            y.cpu(), torch.nn.functional.avg_pool2d(x.cpu(), 3, 1, 1),
            atol=1e-6, rtol=1e-6)
        (y * w.to(dev)).sum().backward()
        grads.append(xi.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)


# ---- the data path and the loops

def test_pyramid_on_the_card_matches_the_cpu(cuda):
    """``preprocess_pyramid`` on the card against the CPU, flips mixed: 256
    (scale, flip, clip) to 2^-22, the rounding of x / 255, which CUDA
    computes as x times the reciprocal (1.2e-7 read on an H100), 128 and
    64 (antialiased bilinear) to 1e-5; ``device_batch`` from the pinned
    host batch leaves the lengths on the host."""
    import numpy as np

    from attngan_torch.data.dataset import (
        Dataset,
        pinned_batch,
        preprocess_pyramid,
    )

    rng = np.random.default_rng(0)
    host = {"pixels": rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8),
            "flip": np.array([True, False, False, True]),
            "tokens": rng.integers(0, 9, (4, 5)).astype(np.int32),
            "lengths": np.array([5, 2, 3, 4], np.int32),
            "class_ids": np.arange(4, dtype=np.int32)}
    pinned = pinned_batch(host, "cuda")
    assert pinned["pixels"].is_pinned() and not pinned["lengths"].is_pinned()
    got = Dataset.device_batch(pinned, "cuda")
    assert got["lengths"].device.type == "cpu"
    want = preprocess_pyramid(torch.from_numpy(host["pixels"]),
                              torch.from_numpy(host["flip"]))
    for res in (256, 128, 64):
        assert got[f"img{res}"].device.type == "cuda"
        torch.testing.assert_close(got[f"img{res}"].cpu(), want[res],
                                   rtol=0.0,
                                   atol=2.0 ** -22 if res == 256 else 1e-5)


def test_tiny_loops_on_the_card_launch_exactly(cuda, tmp_path):
    """Both loops at tiny dims in fp32 on the card (8 images, batch 4: 2
    steps an epoch, 1 epoch; K2 takes gf = 4 in fp32 only): pretraining launches K4 once and K5 twice a step;
    GAN training K1 twice a step and twice a sample grid, K2 twice a grid,
    K4 once and K5 twice a step; K6 never."""
    import numpy as np

    from attngan_torch.core.config import DamsmConfig, GanConfig, RunConfig
    from attngan_torch.data.synthetic import make_synthetic_dataset
    from attngan_torch.ops.cuda_upblock import upblock_fused_eval_cuda
    from attngan_torch.train.loops import run_damsm_training, run_gan_training

    counters = {"k1": word_attention_cuda, "k2": upblock_fused_eval_cuda,
                "k4": damsm_similarity,
                "k5": damsm_similarity_bwd_square,
                "k6": damsm_similarity_bwd_tiled}
    run_cfg = RunConfig(checkpoint_dir=str(tmp_path / "ckpt"),
                        image_dir=str(tmp_path / "img"))

    def launches(fn):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches - before[k] for k, c in counters.items()}

    (_, state, history), got = launches(lambda: run_damsm_training(
        DamsmConfig(emb_dim=32, batch_size=4, epochs=1, image_encoder="tiny",
                    compute_dtype="float32"),
        run_cfg, make_synthetic_dataset(8, res=64)))
    assert state.step == 2 and all(map(np.isfinite, history))
    assert got == {"k1": 0, "k2": 0, "k4": 2, "k5": 4, "k6": 0}
    (_, state, losses), got = launches(lambda: run_gan_training(
        GanConfig(gf_dim=4, df_dim=4, emb_dim=16, seq_len=4, batch_size=4,
                  epochs=1, image_encoder="tiny", compute_dtype="float32"),
        run_cfg, make_synthetic_dataset(8, res=256)))
    assert state.step == 2
    assert all(np.isfinite(v).all() for v in losses.values())
    assert got == {"k1": 2 * 2 + 2, "k2": 2, "k4": 2, "k5": 4, "k6": 0}


# ---- the pretrain options

@pytest.mark.parametrize("form", ["cached", "superbatch", "train_mode_bn"])
def test_pretrain_option_steps_on_the_card_match_the_cpu(cuda, form):
    import numpy as np

    from attngan_torch.core.config import DamsmConfig
    from attngan_torch.train.damsm_trainer import DamsmTrainer

    rng = np.random.default_rng(1)
    k = 2 if form == "superbatch" else 1
    b = 2 if form == "train_mode_bn" else 4
    rows = k * b
    batch = {"tokens": rng.integers(0, 30, (rows, 5)),
             "lengths": rng.integers(1, 6, rows),
             "class_ids": rng.integers(0, 3, rows)}
    if form == "cached":
        batch.update(
            trunk_regions=rng.uniform(0, 2, (rows, 289, 128)).astype(
                np.float16),
            trunk_pooled=rng.uniform(0, 2, (rows, 128)).astype(np.float16))
    else:
        batch["img256"] = np.tanh(rng.standard_normal((rows, 64, 64, 3))
                                  ).astype(np.float32)
    cfg = DamsmConfig(
        emb_dim=32, text_emb_dim=16, batch_size=b, compute_dtype="",
        dropout=0.0, superbatch=k, trunk_train_mode_bn=form == "train_mode_bn",
        image_encoder="inception_v3" if form == "train_mode_bn" else "tiny")
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = DamsmTrainer(cfg, 30, 5, device=dev)
        state = trainer.init_state(seed=2)
        step = {"cached": trainer.train_step_cached,
                "superbatch": trainer.train_step_super,
                "train_mode_bn": trainer.train_step}[form]
        k4, k5 = damsm_similarity.launches, damsm_similarity_bwd_square.launches
        state, m = step(state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (damsm_similarity.launches - k4,
                    damsm_similarity_bwd_square.launches - k5) == (k, 2 * k)
        runs[dev] = ({key: v.cpu().reshape(-1) for key, v in m.items()},
                     {name: p.detach().cpu() for name, p in state.trainable()},
                     {key: v.cpu() for key, v in
                      state.cnn.trunk.state_dict().items()
                      if "running" in key})
    (m_gpu, p_gpu, s_gpu), (m_cpu, p_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    for key, v in m_cpu.items():
        torch.testing.assert_close(m_gpu[key], v, rtol=1e-3, atol=0.0)
    for name, p in p_cpu.items():
        diff = (p_gpu[name] - p).abs()
        assert float(diff.max()) <= 2 * k * cfg.lr + 1e-4, name
        assert float((diff > 1e-4).float().mean()) <= 0.01, name
    assert bool(s_cpu) == (form == "train_mode_bn")
    for key, v in s_cpu.items():
        torch.testing.assert_close(s_gpu[key], v, rtol=1e-3, atol=1e-4)


def test_device_timeit_is_fenced_on_the_card(cuda):
    """utils.timing.device_timeit on calls whose device time (a sleep
    kernel of ~0.5 ms, then an add) exceeds their launch: its seconds a
    call may not read more than 2% under CUDA events recorded before the
    first timed call and after the last, as chip_smoke.py holds it on the
    serving call."""
    from attngan_torch.utils.timing import device_timeit

    x = torch.zeros(1024, device="cuda")
    warmup, iters, calls, marks = 2, 10, [0], []

    def fn():
        calls[0] += 1
        if calls[0] == warmup + 1:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        torch.cuda._sleep(10 ** 6)
        out = x + calls[0]
        if calls[0] == warmup + iters:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        return out

    seconds = device_timeit(fn, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    assert calls[0] == warmup + iters and len(marks) == 2
    events_s = marks[0].elapsed_time(marks[1]) / 1e3 / iters
    assert seconds >= 0.98 * events_s > 0, (seconds, events_s)
