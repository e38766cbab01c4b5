"""The plain versions of the DAMSM similarity kernels (K4-K6) against the JAX
Pallas kernels they replace.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them; the port's wrappers take their plain versions because
the tensors lie on the CPU. The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances: forward and gradients within 1e-4 relative and 1e-5 absolute
(the same fp32 chain in another summation order; observed ~1e-7); in the
extreme-magnitude case 5e-3 / 5e-4, as tests/test_pallas.py holds the
Pallas backward to the vmap oracle there (scores of ~1e3 make the softmax
derivatives sensitive to rounding in the last place of the scores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import attngan_tpu.ops.pallas_damsm as pd
from attngan_tpu.ops.attention import damsm_attention as jax_damsm_attention

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.attention import damsm_attention
from attngan_torch.ops.cuda_damsm import (
    DamsmSimilarity,
    damsm_similarity,
    damsm_similarity_bwd,
    damsm_similarity_bwd_square,
    damsm_similarity_bwd_tiled,
    plan,
    takes_tc,
)
from attngan_torch.ops.damsm_similarity import (
    similarity_bwd_plain,
    similarity_plain,
)

TOL = dict(rtol=1e-4, atol=1e-5)
EXTREME_TOL = dict(rtol=5e-3, atol=5e-4)


def _case(rng, bi=4, bt=4, r=9, d=16, l=4, extreme=False):
    img = rng.standard_normal((bi, r, d)).astype(np.float32)
    words = rng.standard_normal((bt, l, d)).astype(np.float32)
    lengths = np.array([l, 2, 1, 3, l][:bt])
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.int32)
    if extreme:                      # text 0's scores ~ +-1e3, the rest O(1)
        words[0] *= 250.0
    g = rng.standard_normal((bi, bt)).astype(np.float32)
    return img, words, mask, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_grads(img, words, mask, g):
    def f(im, wd):
        return jnp.sum(pd.damsm_similarity_pallas(im, wd, mask,
                                                  interpret=True) * g)
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(words))


CASES = {"square": dict(), "rectangular": dict(bi=3, bt=5),
         "masked_words": dict(bi=5, bt=5, l=4),
         "extreme": dict(bt=4, l=3, extreme=True)}


@pytest.mark.parametrize("name", list(CASES))
def test_similarity_plain_matches_pallas_and_jnp(rng, name):
    img, words, mask, _ = _case(rng, **CASES[name])
    tol = EXTREME_TOL if name == "extreme" else TOL
    got = similarity_plain(_t(img), _t(words), _t(mask)).numpy()
    assert got.shape == (img.shape[0], words.shape[0])
    want_p = pd.damsm_similarity_pallas(img, words, mask, interpret=True)
    want_j = pd._jnp_similarity(img, words, mask, 4.0, 5.0)
    np.testing.assert_allclose(got, np.asarray(want_p), **tol)
    np.testing.assert_allclose(got, np.asarray(want_j), **tol)


def test_similarity_plain_matches_multi_tile_pallas(rng, monkeypatch):
    """Tiles of 2 texts over 5 (K=3 with one padded dummy text), on the JAX
    side; the port's plain version has no tiles."""
    monkeypatch.setattr(pd, "_TILE_FWD", 2)
    img, words, mask, _ = _case(rng, bi=3, bt=5)
    want = pd.damsm_similarity_pallas(img, words, mask, interpret=True)
    got = similarity_plain(_t(img), _t(words), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,tile", [
    ("square", None),             # K5: _similarity_grid_bwd_square
    ("rectangular", None),        # K6: rectangular -> tiled
    ("masked_words", 2),          # K6 with multi-tile grids, a padded text
    ("extreme", None),
])
def test_backward_matches_jax_grad_through_pallas(rng, monkeypatch, name,
                                                  tile):
    if tile:
        monkeypatch.setattr(pd, "_TILE_BWD", tile)
    img, words, mask, g = _case(rng, **CASES[name])
    calls = []
    for fn in ("_similarity_grid_bwd_square", "_similarity_grid_bwd_tiled"):
        orig = getattr(pd, fn)
        monkeypatch.setattr(pd, fn, lambda *a, _o=orig, _n=fn, **k: (
            calls.append(_n), _o(*a, **k))[1])
    want_img, want_words = _jax_grads(img, words, mask, g)
    square = img.shape[0] == words.shape[0] and tile is None
    assert calls == ["_similarity_grid_bwd_" + ("square" if square
                                                else "tiled")]
    got_img, got_words = similarity_bwd_plain(_t(img), _t(words), _t(mask),
                                              _t(g))
    tol = EXTREME_TOL if name == "extreme" else TOL
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), **tol)
    np.testing.assert_allclose(got_words.numpy(), np.asarray(want_words),
                               **tol)


@pytest.mark.parametrize("name", ["square", "rectangular", "masked_words"])
def test_backward_matches_autograd_of_plain_forward(rng, name):
    img, words, mask, g = _case(rng, **CASES[name])
    im, wd = _t(img).requires_grad_(), _t(words).requires_grad_()
    (similarity_plain(im, wd, _t(mask)) * _t(g)).sum().backward()
    got_img, got_words = similarity_bwd_plain(_t(img), _t(words), _t(mask),
                                              _t(g))
    np.testing.assert_allclose(got_img.numpy(), im.grad.numpy(), **TOL)
    np.testing.assert_allclose(got_words.numpy(), wd.grad.numpy(), **TOL)


def test_wrapper_runs_the_plain_versions_on_cpu(rng):
    img, words, mask, g = _case(rng, bi=3, bt=5)
    counts = (damsm_similarity.launches, damsm_similarity.tc_launches,
              damsm_similarity_bwd_square.launches,
              damsm_similarity_bwd_tiled.launches)
    im, wd = _t(img).requires_grad_(), _t(words).requires_grad_()
    sims = damsm_similarity(im, wd, _t(mask))
    assert torch.equal(sims, similarity_plain(_t(img), _t(words), _t(mask)))
    (sims * _t(g)).sum().backward()
    want = similarity_bwd_plain(_t(img), _t(words), _t(mask), _t(g))
    assert torch.equal(im.grad, want[0]) and torch.equal(wd.grad, want[1])
    for fn in (damsm_similarity_bwd, damsm_similarity_bwd_tiled):
        assert all(torch.equal(a, b) for a, b in zip(
            fn(_t(img), _t(words), _t(mask), _t(g)), want))
    assert (damsm_similarity.launches, damsm_similarity.tc_launches,
            damsm_similarity_bwd_square.launches,
            damsm_similarity_bwd_tiled.launches) == counts


def test_square_case_takes_only_square_batches(rng):
    img, words, mask, g = _case(rng, bi=3, bt=5)
    with pytest.raises(ValueError, match="square"):
        damsm_similarity_bwd_square(_t(img), _t(words), _t(mask), _t(g))


def test_autograd_function_with_plain_impls_matches_pallas_vjp(rng):
    """The autograd.Function the GPU path uses, fed the plain versions."""
    img, words, mask, g = _case(rng, bi=3, bt=5)
    im, wd = _t(img).requires_grad_(), _t(words).requires_grad_()
    sims = DamsmSimilarity.apply(im, wd, _t(mask), 4.0, 5.0,
                                 similarity_plain, similarity_bwd_plain)
    (sims * _t(g)).sum().backward()
    want_img, want_words = _jax_grads(img, words, mask, g)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(want_img), **TOL)
    np.testing.assert_allclose(wd.grad.numpy(), np.asarray(want_words), **TOL)


def test_text_with_no_word_gets_zero_gradient(rng):
    img, words, mask, g = _case(rng, bi=3, bt=4)
    mask[2] = 0
    sims = similarity_plain(_t(img), _t(words), _t(mask))
    assert bool(torch.isneginf(sims[:, 2]).all())
    _, d_words = similarity_bwd_plain(_t(img), _t(words), _t(mask), _t(g))
    assert float(d_words[2].abs().max()) == 0.0
    assert bool(torch.isfinite(d_words).all())


@pytest.mark.parametrize("bi,bt,l,d,want", [
    (64, 64, 8, 256, (8, 8, 2)),      # full width: 128 blocks, 4 tiles each
    (192, 192, 8, 256, (8, 24, 2)),
    (16, 64, 8, 256, (8, 8, 8)),      # the sharded shape: one tile a block
    (4, 5, 4, 16, (32, 1, 1)),        # D=16: the CUDA-core pass, 128 rows
    (5, 30, 5, 128, (12, 3, 3)),      # tensor-core tiles: at most 64 rows
    (4, 5, 12, 128, (10, 1, 1)),      # 12 words: the CUDA-core pass
])
def test_plan_fills_the_card(bi, bt, l, d, want):
    assert plan(bi, bt, l, d) == want


@pytest.mark.parametrize("bi,bt,want", [
    (64, 64, 2),          # one wave of 128 blocks, 4 tiles each
    (192, 192, 24),       # a block per tile: 35 waves (2 splits: 3 x 12)
    (16, 64, 8)])
def test_forward_plan_takes_the_fewest_waves_times_tiles(bi, bt, want):
    assert plan(bi, bt, 8, 256, slack=1.0) == (8, -(-bt // 8), want)


@pytest.mark.parametrize("l,d,want", [(8, 256, True), (3, 32, True),
                                      (8, 16, False), (9, 256, False)])
def test_backward_form_by_shape(l, d, want):
    """The forward and the backward's pass take the tensor cores at D a
    multiple of 32 and texts of at most 8 words (their softmaxes hold a
    text in registers)."""
    assert takes_tc(l, d) == want


@pytest.mark.parametrize("bi,bt,l,d", [
    (64, 64, 8, 256), (16, 64, 8, 256),
    (3, 61, 8, 256),                  # ragged Bt: the last tile holds 5 texts
    (5, 30, 5, 128), (2, 7, 3, 32), (1, 1, 8, 64)])
def test_plan_covers_every_pair_once(bi, bt, l, d):
    """The tensor-core kernels' walk over any grid of plan's tiles: block
    (split s, image j) takes the text tiles s, s + S, ... < K, tile k the
    texts k T .. min(Bt, (k + 1) T) - 1. At every S from 1 to K, the
    forward's and the backward's among them, every (image, text) pair is
    computed once."""
    t, k, s_bwd = plan(bi, bt, l, d)
    s_fwd = plan(bi, bt, l, d, slack=1.0)[2]
    assert takes_tc(l, d) and t * l <= 64 and 1 <= s_bwd <= k
    assert 1 <= s_fwd <= k
    for s in range(1, k + 1):
        seen = np.zeros((bi, bt), dtype=int)
        for j in range(bi):
            for split in range(s):
                for tile in range(split, k, s):
                    seen[j, tile * t:min(bt, (tile + 1) * t)] += 1
        assert (seen == 1).all()


def test_plan_rejects_texts_longer_than_a_tile():
    with pytest.raises(ValueError, match="does not fit"):
        plan(4, 4, 65, 256)


def test_damsm_attention_matches_jax(rng):
    img, words, mask, _ = _case(rng, bi=3, bt=3)
    want_w, want_a = jax_damsm_attention(words, img, 4.0, mask=mask)
    got_w, got_a = damsm_attention(_t(words), _t(img), 4.0, mask=_t(mask))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
