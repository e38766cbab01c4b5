"""The port's discriminator blocks, discriminators and GAN losses against
attngan_tpu's, on the CPU.

Blocks (DownBlock, Block3x3LeakyRelu, ImageEncoder16x) and the
Discriminator at 64, 128 and 256 are initialised by flax, converted with
attngan_torch.convert's discriminator mapping (``_disc_key``) and run on
the same inputs in train mode (outputs and the updated running
statistics) and in eval mode. Tolerance 1e-5 absolute plus 1e-4 relative:
the same fp32 convolutions in other summation orders.

The losses (non-saturating, standard with injected real labels and with the
midpoint labels, the generator's two, the KL) are compared in value and in
gradient, also at probabilities 0 and 1, where the 1e-8 epsilons and the
standard loss's clip decide the value (inf and nan included: both give the
same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.losses import gan as jax_gan
from attngan_tpu.models.discriminators import Discriminator as JaxDiscriminator
from attngan_tpu.ops import layers as jax_layers

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import _disc_key, _layout
from attngan_torch.losses import gan
from attngan_torch.models.discriminators import Discriminator
from attngan_torch.ops.layers import (
    Block3x3LeakyRelu,
    DownBlock,
    ImageEncoder16x,
)

DF, B = 4, 3
TOL = dict(atol=1e-5, rtol=1e-4)


def _state_dict(variables, scope: str = "", port_scope: str = "") -> dict:
    """flax variables -> the port module's state_dict; a block is mapped as
    it sits in a discriminator, flax ``scope`` -> the port's ``port_scope``
    (dropped from the keys)."""
    sd = {}
    for tree in ("params", "batch_stats"):
        flat = traverse_util.flatten_dict(variables.get(tree, {}), sep="/")
        for path, value in flat.items():
            key = _disc_key(scope + path)
            assert key.startswith(port_scope), key
            sd[key[len(port_scope):]] = _layout(value)
    return sd


def _inputs(shape, seed=0):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)
                   ).astype(np.float32)


def _run_both(jax_module, port_module, x_nhwc, scopes=("", "")):
    """Both modules in train mode (outputs, updated statistics) then eval
    mode (outputs, from the updated statistics)."""
    x = jnp.asarray(x_nhwc)
    variables = jax_module.init(jax.random.key(1), x, train=True)
    port_module.load_state_dict(_state_dict(variables, *scopes), strict=True)
    want_train, mut = jax_module.apply(variables, x, train=True,
                                       mutable=["batch_stats"])
    want_eval = jax_module.apply({**variables, **mut}, x, train=False)
    xt = torch.from_numpy(x_nhwc)
    if xt.dim() == 4 and not isinstance(port_module, Discriminator):
        xt = xt.permute(0, 3, 1, 2)           # the blocks take NCHW
    got_train = port_module.train()(xt)
    got_stats = {k: v for k, v in port_module.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
    got_eval = port_module.eval()(xt)
    want_stats = _state_dict({"batch_stats": mut["batch_stats"]}, *scopes)
    return (got_train, got_eval, got_stats), (want_train, want_eval,
                                              want_stats)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


BLOCKS = {
    "down": (lambda: jax_layers.DownBlock(2 * DF),
             lambda: DownBlock(DF, 2 * DF), (B, 16, 16, DF),
             ("DownBlock_0/", "down.0.")),
    "block3x3": (lambda: jax_layers.Block3x3LeakyRelu(DF),
                 lambda: Block3x3LeakyRelu(2 * DF, DF), (B, 8, 8, 2 * DF),
                 ("Block3x3LeakyRelu_0/", "squeeze.0.")),
    "encoder16x": (lambda: jax_layers.ImageEncoder16x(DF),
                   lambda: ImageEncoder16x(DF), (B, 64, 64, 3),
                   ("ImageEncoder16x_0/", "encoder.")),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port, shape, scopes = BLOCKS[name]
    port = make_port()
    got, want = _run_both(make_jax(), port, _inputs(shape), scopes)
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), **TOL,
                               err_msg="train")
    np.testing.assert_allclose(_nhwc(got[1]), np.asarray(want[1]), **TOL,
                               err_msg="eval")
    assert set(got[2]) == set(want[2]) and got[2]
    for k, v in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    # train mode moved the statistics off their init
    assert any(float((v - float(k.endswith("var"))).abs().max()) > 1e-3
               for k, v in got[2].items())


@pytest.mark.parametrize("res", [64, 128, 256])
def test_discriminator_matches_jax(res):
    port = Discriminator(DF, res)
    x = _inputs((B, res, res, 3), seed=res)
    got, want = _run_both(JaxDiscriminator(df_dim=DF, resolution=res), port,
                          x)
    for mode, g, w in (("train", got[0], want[0]), ("eval", got[1], want[1])):
        assert g.shape == (B,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL,
                                   err_msg=mode)
    assert set(got[2]) == set(want[2])
    n_bn = {64: 3, 128: 5, 256: 7}[res]
    assert len(got[2]) == 2 * n_bn
    for k, v in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    # the layout: the port's modules in flax's order, nothing left over
    n_params = len(jax.tree_util.tree_leaves(
        JaxDiscriminator(df_dim=DF, resolution=res).init(
            jax.random.key(0), jnp.zeros((1, res, res, 3)))["params"]))
    assert n_params == len(list(port.parameters()))


def test_discriminator_runs_in_bf16_and_checks_its_input():
    port = Discriminator(DF, 64, dtype=torch.bfloat16)
    x = torch.from_numpy(_inputs((B, 64, 64, 3)))
    probs = port.train()(x)
    assert probs.dtype == torch.float32 and probs.shape == (B,)
    assert port.encoder.bn[0].running_mean.dtype == torch.float32
    with pytest.raises(ValueError, match="expected 64px"):
        port(torch.zeros(B, 128, 128, 3))
    with pytest.raises(ValueError, match="no discriminator"):
        Discriminator(DF, 32)


def _probs(seed, edges):
    p = np.random.default_rng(seed).uniform(0.02, 0.98, 6).astype(np.float32)
    if edges:
        p[:2] = (0.0, 1.0) if seed % 2 else (1.0, 0.0)
    return p


LOSSES = {
    "non_saturating_disc": (gan.non_saturating_disc_loss,
                            jax_gan.non_saturating_disc_loss, 2),
    "non_saturating_gen": (gan.non_saturating_gen_loss,
                           jax_gan.non_saturating_gen_loss, 1),
    "standard_gen": (gan.standard_gen_loss, jax_gan.standard_gen_loss, 1),
    "standard_disc_midpoint": (
        lambda r, f: gan.standard_disc_loss(r, f, None, 0.8),
        lambda r, f: jax_gan.standard_disc_loss(r, f, None, 0.8), 2),
}


@pytest.mark.parametrize("edges", [False, True], ids=["inside", "edges"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_gan_losses_match_jax(name, edges):
    port_fn, jax_fn, n = LOSSES[name]
    args = [_probs(seed, edges) for seed in range(n)]
    want = jax_fn(*map(jnp.asarray, args))
    got = port_fn(*map(torch.from_numpy, args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if name.startswith("non_saturating"):
        assert np.isfinite(float(got))            # the 1e-8 inside the logs
    if not edges:
        grads = jax.grad(lambda *a: jax_fn(*a), argnums=tuple(range(n)))(
            *map(jnp.asarray, args))
        ts = [torch.from_numpy(a).requires_grad_() for a in args]
        port_fn(*ts).backward()
        for t, g in zip(ts, grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-5)


def test_standard_disc_loss_with_injected_labels_matches_jax():
    real, fake = _probs(0, False), _probs(1, False)
    key = jax.random.key(3)
    labels = jax.random.uniform(key, (real.shape[0],), minval=0.8,
                                maxval=1.0)
    want = jax_gan.standard_disc_loss(jnp.asarray(real), jnp.asarray(fake),
                                      key, 0.8)
    got = gan.standard_disc_loss(torch.from_numpy(real),
                                 torch.from_numpy(fake),
                                 torch.from_numpy(np.array(labels)), 0.8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the clip: a fake probability of exactly 0 costs -log(1 - 1e-8)
    fake[0] = 0.0
    got = gan.standard_disc_loss(torch.from_numpy(real),
                                 torch.from_numpy(fake),
                                 torch.from_numpy(np.array(labels)), 0.8)
    want = jax_gan.standard_disc_loss(jnp.asarray(real), jnp.asarray(fake),
                                      key, 0.8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert np.isfinite(float(got))


def test_kl_loss_matches_jax():
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((B, 8)).astype(np.float32)
    logvar = (0.5 * rng.standard_normal((B, 8))).astype(np.float32)
    want = jax_gan.kl_loss(jnp.asarray(mu), jnp.asarray(logvar))
    mu_t = torch.from_numpy(mu).requires_grad_()
    lv_t = torch.from_numpy(logvar).requires_grad_()
    got = gan.kl_loss(mu_t, lv_t)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()
    g_mu, g_lv = jax.grad(jax_gan.kl_loss, argnums=(0, 1))(
        jnp.asarray(mu), jnp.asarray(logvar))
    np.testing.assert_allclose(mu_t.grad.numpy(), np.asarray(g_mu), rtol=1e-5)
    np.testing.assert_allclose(lv_t.grad.numpy(), np.asarray(g_lv), rtol=1e-5)
