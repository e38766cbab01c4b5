"""The port's DAMSM losses against attngan_tpu/losses/damsm.py.

Both routes of the port's words loss (``fused``: the kernels' autograd
Function, here with their plain versions on the CPU; and the plain
vectorised form) against the JAX vmap form, values and gradients, with and
without class ids. Tolerance 1e-4 relative, 1e-5 absolute: the same fp32
math in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attngan_tpu.losses import damsm as jax_damsm

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.losses import damsm

TOL = dict(rtol=1e-4, atol=1e-5)
B, L, R, D = 4, 4, 9, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def case(rng):
    img = rng.standard_normal((B, R, D)).astype(np.float32)
    words = rng.standard_normal((B, L, D)).astype(np.float32)
    code = rng.standard_normal((B, D)).astype(np.float32)
    sent = rng.standard_normal((B, D)).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([4, 2, 1, 3])[:, None]).astype(
        np.int32)
    return img, words, code, sent, mask


CLASS_IDS = {"no_class_ids": None, "class_ids": np.array([0, 1, 0, 2])}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("cls", list(CLASS_IDS))
def test_words_loss_and_grads_match_jax(case, fused, cls):
    img, words, _, _, mask = case
    class_ids = CLASS_IDS[cls]
    labels = np.arange(B)

    def jax_loss(im, wd):
        return jax_damsm.words_loss(im, wd, labels, mask, class_ids,
                                    fused=False)[0]

    want, (want_di, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(words))
    _, want_attn = jax_damsm.words_loss(img, words, labels, mask, class_ids,
                                        fused=False)
    im, wd = _t(img).requires_grad_(), _t(words).requires_grad_()
    got, attn = damsm.words_loss(
        im, wd, torch.arange(B), _t(mask),
        None if class_ids is None else _t(class_ids), fused=fused)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(want_di), **TOL)
    np.testing.assert_allclose(wd.grad.numpy(), np.asarray(want_dw), **TOL)
    assert attn.shape == (B, L, R)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               **TOL)


def test_words_loss_skips_the_maps_it_is_not_asked_for(case):
    img, words, _, _, mask = case
    for fused in (True, False):
        _, attn = damsm.words_loss(_t(img), _t(words), torch.arange(B),
                                   _t(mask), None, fused=fused,
                                   attention_maps=False)
        assert attn is None


def test_fused_defaults_to_the_kernels_only_on_cuda(case, monkeypatch):
    import attngan_torch.ops.cuda_damsm as cd

    img, words, _, _, mask = case
    calls = []
    monkeypatch.setattr(cd, "words_loss_fused",
                        lambda *a: calls.append(1) or torch.zeros(()))
    damsm.words_loss(_t(img), _t(words), torch.arange(B), _t(mask), None)
    assert calls == []                      # CPU tensors: the plain form
    damsm.words_loss(_t(img), _t(words), torch.arange(B), _t(mask), None,
                     fused=True)
    assert calls == [1]


@pytest.mark.parametrize("cls", list(CLASS_IDS))
def test_sentence_loss_matches_jax(case, cls):
    _, _, code, sent, _ = case
    class_ids = CLASS_IDS[cls]
    labels = np.arange(B)
    want = jax_damsm.sentence_loss(code, sent, labels, class_ids)
    got = damsm.sentence_loss(_t(code), _t(sent), torch.arange(B),
                              None if class_ids is None else _t(class_ids))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("cls", list(CLASS_IDS))
def test_damsm_loss_matches_jax(case, cls):
    img, words, code, sent, mask = case
    class_ids = CLASS_IDS[cls]
    want_total, want_parts, want_attn = jax_damsm.damsm_loss(
        img, code, words, sent, np.arange(B), mask, class_ids)
    total, parts, attn = damsm.damsm_loss(
        _t(img), _t(code), _t(words), _t(sent), torch.arange(B), _t(mask),
        None if class_ids is None else _t(class_ids))
    np.testing.assert_allclose(float(total), float(want_total), **TOL)
    for k in ("words_loss", "sentence_loss"):
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   **TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), **TOL)


def test_cosine_similarity_and_class_mask_match_jax(rng):
    a = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b = rng.standard_normal((3, 5, 8)).astype(np.float32)
    b[0, 0] = 0.0                                    # the 1e-8 clamp
    np.testing.assert_allclose(
        damsm.cosine_similarity(_t(a), _t(b)).numpy(),
        np.asarray(jax_damsm.cosine_similarity(a, b)), **TOL)
    ids = np.array([0, 1, 0, 1, 2])
    assert np.array_equal(damsm._class_mask(_t(ids)).numpy(),
                          np.asarray(jax_damsm._class_mask(ids)))
