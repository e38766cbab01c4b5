"""The port's VAE embedders against attngan_tpu's, on the CPU.

- The three layer blocks (UpBlockReLU, DownBlockLeakyReLU, Block3x3Relu)
  from the same weights: outputs in train and eval mode and the running
  statistics after a train forward, within 1e-4.
- DFCVAE with JAX's truncated widths (4 ... 128) at 64^2 through
  ``convert.load_vae_flat``, with JAX's noise injected: reconstructions,
  mu, logvar in train and eval mode and the running statistics after the
  train forward (the 1x1 bottleneck's BN over 2 rows: the unbiased
  variance doubles the biased one); the decoder's transposed convs are
  flax's "SAME" ones, which torch's padding=1, output_padding=1 misses by
  a pixel.
- The AutoEncoder at 256^2, batch 1, in train mode, likewise: its 1x1
  bottleneck's BN then holds one value a channel (JAX gives the bias;
  torch's F.batch_norm refuses). At batch 2 the decoder's train-mode BN
  over 2 x 2 x 2 values amplifies fp32 rounding past 1e-4 (port against
  JAX, measured: 1.7e-4 on the image, 1.5e-4 of the largest gradient).
- dfc_vae_loss (with VGG19-BN features of both images) and
  autoencoder_loss, and their gradients into every parameter, against
  jax.grad: each within 1e-4 of its tensor's largest gradient (the
  DFCVAE's reach ~20: its 1x1 bottleneck's train-mode BN over 2 rows).
- VAEEmbedder: logvar for "dfc", the sampled z for "ae" with JAX's noise;
  the clusterer fed by a DFCVAE embedder writes JAX's captions.
- The training helpers of utils/training.py, and timing.count_parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from attngan_tpu.data import clusterer as jax_clusterer
from attngan_tpu.data import synthetic as jax_synthetic
from attngan_tpu.models import vae as jax_vae
from attngan_tpu.models.vgg import VGG19BNFeatures as JaxVGG
from attngan_tpu.ops import layers as jax_layers
from attngan_tpu.utils import training as jax_training

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch import convert
from attngan_torch.data import clusterer, synthetic
from attngan_torch.models import vae
from attngan_torch.models.vgg import VGG19BNFeatures
from attngan_torch.ops import layers
from attngan_torch.utils import count_parameters, training

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4
TRUNCATED = (4, 8, 16, 32, 64, 128)
LOSS_TAPS = (3, 8)            # a conv tap and a BN tap (collected post-ReLU)


def randomized(variables, seed: int):
    """(flat {path: array}, flax tree) of ``variables`` (arrays or their
    shapes, jax.eval_shape's): every leaf drawn anew (kernels
    fan-in scaled, BN scales, biases and statistics away from the init's),
    so that a transposed or misplaced leaf shows."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, value in traverse_util.flatten_dict(variables, sep="/").items():
        shape, leaf = value.shape, key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            v = rng.normal(0, 0.1, shape)
        flat[key] = v.astype(np.float32)
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    return flat, tree


def flat_of(tree, prefix: str):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def nchw(x):
    return torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2).contiguous()


def assert_stats(model, flat, updated_stats, **tol):
    """``model``'s running statistics equal JAX's after its train forward."""
    want = convert.convert_vae_flat({**flat, **flat_of(updated_stats,
                                                       "batch_stats")})
    sd = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), **tol,
                                   err_msg=k)


def assert_grads(model, jax_grads):
    """Every parameter's gradient within GRAD_TOL of the tensor's largest
    JAX gradient (or of 1, where that is smaller)."""
    want = convert.convert_vae_flat(flat_of(jax_grads, "params"))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, v in want.items():
        w = v.numpy()
        err = np.abs(got[k].grad.numpy() - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), (k, err)


# ---------------------------------------------------------------- blocks

BLOCKS = {
    "UpBlockReLU": (jax_layers.UpBlockReLU, layers.UpBlockReLU, "up.0", 4),
    "DownBlockLeakyReLU": (jax_layers.DownBlockLeakyReLU,
                           layers.DownBlockLeakyReLU, "down.0", 16),
    "Block3x3Relu": (jax_layers.Block3x3Relu, layers.Block3x3Relu, None, 8),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_jax(name):
    jax_cls, torch_cls, port_scope, hw = BLOCKS[name]
    ci, co = 6, 5
    x = np.random.default_rng(1).normal(size=(3, hw, hw, ci)).astype(
        np.float32)
    module = jax_cls(co)
    flat, tree = randomized(jax.eval_shape(lambda: module.init(
        jax.random.key(0), x, train=False)), seed=2)
    block = torch_cls(ci, co)
    if port_scope is None:          # not a VAE block: its two leaves by name
        names = {"Conv_0": "conv", "TorchBatchNorm_0": "bn"}
        leaves = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}
        sd = {f"{names[k.split('/')[1]]}.{leaves[k.split('/')[2]]}":
              convert._layout(v) for k, v in flat.items()}
    else:                           # through the AutoEncoder's converter
        scope = "UpBlockReLU_0" if name.startswith("Up") else \
            "DownBlockLeakyReLU_0"
        sd = {k[len(port_scope) + 1:]: v for k, v in convert.convert_vae_flat(
            {f"{t}/{scope}/{rest}": v for t, rest, v in
             ((k.split("/", 1)[0], k.split("/", 1)[1], v)
              for k, v in flat.items())}).items()}
    block.load_state_dict(sd, strict=True)
    want_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))(tree, x)
    got_eval = block.eval()(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_eval.detach().numpy(), want_eval, **TOL)
    want, updates = jax.jit(lambda v, x: module.apply(
        v, x, train=True, mutable=["batch_stats"]))(tree, x)
    got = block.train()(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    new = flat_of(updates["batch_stats"], "batch_stats")
    np.testing.assert_allclose(block.bn.running_mean.numpy(),
                               new["batch_stats/TorchBatchNorm_0/mean"], **TOL)
    np.testing.assert_allclose(block.bn.running_var.numpy(),
                               new["batch_stats/TorchBatchNorm_0/var"], **TOL)
    assert layers.calculate_out_hw(256, 4, 2, 1) == \
        jax_layers.calculate_out_hw(256, 4, 2, 1) == 128


def test_transposed_conv_is_flax_same_not_torch_padding():
    """One flax ConvTranspose(3, 2, "SAME") against the port's, and torch's
    usual alignment a pixel off it."""
    from flax import linen as nn

    x = np.random.default_rng(3).normal(size=(2, 5, 5, 4)).astype(np.float32)
    layer = nn.ConvTranspose(6, (3, 3), strides=(2, 2), padding="SAME")
    flat, tree = randomized(jax.eval_shape(
        lambda: layer.init(jax.random.key(0), x)), seed=4)
    want = np.asarray(layer.apply(tree, x))
    sd = convert.convert_vae_flat({k.replace("params/", "params/ConvTranspose_0/"): v
                                   for k, v in flat.items()})
    port = vae.ConvTransposeSame(4, 6)
    port.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    got = port(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 10, 10, 6)
    np.testing.assert_allclose(got, want, **TOL)
    usual = F.conv_transpose2d(nchw(x), port.weight, port.bias, stride=2,
                               padding=1, output_padding=1)
    assert np.abs(usual.permute(0, 2, 3, 1).detach().numpy() - want).max() > 0.1


# ---------------------------------------------------------------- DFCVAE

@pytest.fixture(scope="module")
def dfcvae():
    """(JAX module, flat, tree, port DFCVAE, images, noise) at 64^2."""
    rng = np.random.default_rng(5)
    x = np.tanh(rng.normal(size=(2, 64, 64, 3))).astype(np.float32)
    model = jax_vae.DFCVAE(latent_dim=16, hidden_dims=TRUNCATED)
    variables = jax.eval_shape(lambda: model.init(
        jax.random.key(0), x, jax.random.key(1), train=False))
    flat, tree = randomized(variables, seed=6)
    port = vae.DFCVAE(latent_dim=16, hidden_dims=TRUNCATED)
    convert.load_vae_flat(flat, port)
    key = jax.random.key(7)
    eps = np.asarray(jax.random.normal(key, (2, 16), jnp.float32))
    return model, flat, tree, port, x, key, eps


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dfcvae_matches_jax(dfcvae, train):
    model, flat, tree, port, x, key, eps = dfcvae
    port = vae.DFCVAE(latent_dim=16, hidden_dims=TRUNCATED)
    convert.load_vae_flat(flat, port)
    port.train(train)
    got = port(torch.as_tensor(x), eps=torch.as_tensor(eps))
    if train:
        want, updates = jax.jit(lambda v: model.apply(
            v, x, key, train=True, mutable=["batch_stats"]))(tree)
        assert_stats(port, flat, updates["batch_stats"], **TOL)
    else:
        want = jax.jit(lambda v: model.apply(v, x, key, train=False))(tree)
    assert got[0].shape == (2, 64, 64, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_dfc_loss_and_gradients_match_jax(dfcvae):
    model, flat, tree, port, x, key, eps = dfcvae
    jvgg = JaxVGG(taps=LOSS_TAPS)
    vgg_flat, vgg_tree = randomized(jax.eval_shape(
        lambda: jvgg.init(jax.random.key(2), x)), seed=8)

    @jax.jit
    def loss_and_grad(params):
        def loss(params):
            (recons, mu, logvar), _ = model.apply(
                {"params": params, "batch_stats": tree["batch_stats"]}, x,
                key, train=True, mutable=["batch_stats"])
            return jax_vae.dfc_vae_loss(
                recons, x, mu, logvar, jvgg.apply(vgg_tree, recons),
                jvgg.apply(vgg_tree, x))
        return jax.value_and_grad(loss)(params)

    want, grads = loss_and_grad(tree["params"])
    vgg = VGG19BNFeatures(taps=LOSS_TAPS)
    convert.load_vgg_flat(vgg_flat, vgg)
    port = vae.DFCVAE(latent_dim=16, hidden_dims=TRUNCATED)
    convert.load_vae_flat(flat, port)
    xt = torch.as_tensor(x)
    recons, mu, logvar = port.train()(xt, eps=torch.as_tensor(eps))
    got = vae.dfc_vae_loss(recons, xt, mu, logvar, vgg(recons), vgg(xt))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert_grads(port, grads)
    assert all(p.grad is None for p in vgg.parameters())
    # without features: the pixel and KLD terms alone, as JAX's
    plain = vae.dfc_vae_loss(recons, xt, mu, logvar, alpha=0.5, beta=2.0)
    np.testing.assert_allclose(
        float(plain), float(jax_vae.dfc_vae_loss(
            jnp.asarray(recons.detach().numpy()), x,
            jnp.asarray(mu.detach().numpy()),
            jnp.asarray(logvar.detach().numpy()), alpha=0.5, beta=2.0)),
        rtol=1e-6)


# ------------------------------------------------------------ AutoEncoder

@pytest.fixture(scope="module")
def autoencoder():
    rng = np.random.default_rng(9)
    x = np.tanh(rng.normal(size=(1, 256, 256, 3))).astype(np.float32)
    model = jax_vae.AutoEncoder(nz=8)
    variables = jax.eval_shape(lambda: model.init(
        jax.random.key(0), x, jax.random.key(1), train=False))
    flat, tree = randomized(variables, seed=10)
    key = jax.random.key(11)
    eps = np.asarray(jax.random.normal(key, (1, 8), jnp.float32))
    return model, flat, tree, x, key, eps


def test_autoencoder_train_step_matches_jax(autoencoder):
    """Outputs, running statistics and the loss's gradients in train mode
    at 256^2 (the encoder ends at 1x1x1024: BN over the batch alone)."""
    model, flat, tree, x, key, eps = autoencoder

    @jax.jit
    def run(params):
        def loss(params):
            (z, decoded, mu, logvar), updates = model.apply(
                {"params": params, "batch_stats": tree["batch_stats"]}, x,
                key, train=True, mutable=["batch_stats"])
            return (jax_vae.autoencoder_loss(decoded, x, mu, logvar),
                    ((z, decoded, mu, logvar), updates))
        return jax.value_and_grad(loss, has_aux=True)(params)

    (want_loss, (want, updates)), grads = run(tree["params"])
    port = vae.AutoEncoder(nz=8)
    convert.load_vae_flat(flat, port)
    xt = torch.as_tensor(x)
    got = port.train()(xt, eps=torch.as_tensor(eps))
    loss = vae.autoencoder_loss(got[1], xt, got[2], got[3])
    loss.backward()
    assert got[1].shape == (1, 256, 256, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_stats(port, flat, updates["batch_stats"], **TOL)
    assert_grads(port, grads)


# -------------------------------------------------------------- embedders

def test_vae_embedder_kinds_match_jax(dfcvae, autoencoder):
    """dfc -> logvar (the reference's quirk), ae -> the sampled z with
    JAX's per-batch noise (its key split once a batch); a ragged last
    batch; the kinds refused."""
    model, flat, tree, _, _, _, _ = dfcvae
    images = np.random.default_rng(12).uniform(
        -1, 1, (3, 64, 64, 3)).astype(np.float32)
    want = jax_vae.VAEEmbedder(model, tree, kind="dfc").embed(images, 2)
    port = vae.DFCVAE(latent_dim=16, hidden_dims=TRUNCATED)
    convert.load_vae_flat(flat, port)
    got = vae.VAEEmbedder(port, "dfc", device="cpu").embed(images, 2)
    assert got.shape == (3, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)

    ae_model, ae_flat, ae_tree, x, _, _ = autoencoder
    images = np.concatenate([x, x * 0.5, -x])
    want = jax_vae.VAEEmbedder(ae_model, ae_tree, kind="ae",
                               seed=3).embed(images, 2)
    rng, eps = jax.random.key(3), []
    for b in (2, 1):
        rng, sub = jax.random.split(rng)
        eps.append(np.asarray(jax.random.normal(sub, (b, 8), jnp.float32)))
    port = vae.AutoEncoder(nz=8)
    convert.load_vae_flat(ae_flat, port)
    embedder = vae.VAEEmbedder(port, "ae", device="cpu")
    got = embedder.embed(images, 2, eps=eps)
    np.testing.assert_allclose(got, want, **TOL)
    drawn = embedder.embed(images, 2)            # the generator's draws
    assert np.isfinite(drawn).all() and not np.allclose(drawn, got)
    with pytest.raises(ValueError, match="kind"):
        vae.VAEEmbedder(port, "resnet", device="cpu")


def test_clusterer_with_a_dfcvae_embedder_writes_jaxs_captions():
    """HierarchicalClusterer(embedder=VAEEmbedder(DFCVAE(), "dfc")) on a
    tiny scene corpus: the port's captions and class ids equal JAX's."""
    x = np.zeros((1, 256, 256, 3), np.float32)
    model = jax_vae.DFCVAE(latent_dim=8, hidden_dims=(2, 4, 4, 8, 8, 8, 8, 8))
    variables = jax.eval_shape(lambda: model.init(
        jax.random.key(0), x, jax.random.key(1), train=False))
    flat, tree = randomized(variables, seed=13)
    port = vae.DFCVAE(latent_dim=8, hidden_dims=(2, 4, 4, 8, 8, 8, 8, 8))
    convert.load_vae_flat(flat, port)
    jds, _ = jax_synthetic.make_scene_dataset(12, seed=0)
    pds, _ = synthetic.make_scene_dataset(12, seed=0)
    jax_clusterer.HierarchicalClusterer(
        embedder=jax_vae.VAEEmbedder(model, tree, "dfc")).cluster(
            jds, latent_dims=8, max_vocab_size=16, min_clusters=1)
    clusterer.HierarchicalClusterer(
        embedder=vae.VAEEmbedder(port, "dfc", device="cpu"),
        device="cpu").cluster(pds, latent_dims=8, max_vocab_size=16,
                              min_clusters=1)
    assert [r.caption for r in pds.records] == \
        [r.caption for r in jds.records]
    assert [r.class_id for r in pds.records] == \
        [r.class_id for r in jds.records]
    assert len({r.class_id for r in pds.records}) > 1


# ---------------------------------------------------------------- helpers

def test_training_helpers_match_jax():
    x = np.linspace(0, 255, 12, dtype=np.float32).reshape(3, 4)
    t = torch.as_tensor(x)
    np.testing.assert_allclose(training.scale_255_to_1(t).numpy(),
                               jax_training.scale_255_to_1(x), rtol=1e-6)
    y = training.scale_255_to_1(t)
    np.testing.assert_allclose(training.scale_1_to_255(y).numpy(), x,
                               atol=1e-4)
    np.testing.assert_allclose(training.scale_1_to_255(y).numpy(),
                               jax_training.scale_1_to_255(y.numpy()),
                               rtol=1e-6)
    a = training.noise_vector(torch.Generator().manual_seed(0), 4, 3)
    b = training.noise_vector(torch.Generator().manual_seed(0), 4, 3, "cpu")
    assert a.shape == (4, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and a.std() > 0
    assert jax_training.noise_vector(jax.random.key(0), 4, 3).shape == (4, 3)
    for args in [(256, 4, 2, 1), (64, 3, 1, 1), (17, 3, 2)]:
        assert training.calculate_out_hw(*args) == \
            jax_training.calculate_out_hw(*args)
    ae = vae.AutoEncoder(nz=8)
    shapes = jax.eval_shape(lambda: jax_vae.AutoEncoder(nz=8).init(
        jax.random.key(0), jnp.zeros((1, 256, 256, 3)), jax.random.key(1),
        train=False))["params"]
    assert count_parameters(ae, verbose=False) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes))
