"""The port's image encoder against attngan_tpu/models/cnn_encoder.py.

Flax blocks are initialised, their weights and BN statistics redrawn with
numpy (statistics away from 0 / 1, so a misplaced leaf shows), and loaded
into the port's blocks through attngan_torch.convert.block_state_dict.
Both run in fp32 on the CPU (JAX at "highest" matmul precision,
tests/conftest.py), in eval mode.

Tolerance: 1e-3 relative, 2e-4 absolute, as tests/test_torch_oracle_trunks.py
holds the flax trunk to its torch oracle: XLA and PyTorch's CPU convs sum
the 768-2048-channel contractions in other orders and drift ~1e-4. The
small blocks sit at ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import attngan_tpu.models.cnn_encoder as jcnn

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import block_state_dict
from attngan_torch.models import cnn_encoder as tcnn

TOL = dict(rtol=1e-3, atol=2e-4)


def _draw(tree, rng):
    def draw(path, x):
        name = path[-1]
        if name in ("var", "scale"):
            a = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("mean", "bias"):
            a = rng.standard_normal(x.shape) * 0.1
        else:
            a = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        return a.astype(np.float32)
    flat = traverse_util.flatten_dict(tree)
    return traverse_util.unflatten_dict({k: draw(k, v) for k, v in flat.items()})


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_and_port(jax_block, port_block, x_nhwc, rng):
    variables = jax.eval_shape(lambda: jax_block.init(
        jax.random.key(0), jnp.asarray(x_nhwc), train=False))
    params = _draw(variables["params"], rng)
    stats = _draw(variables.get("batch_stats", {}), rng)
    port_block.load_state_dict(block_state_dict(_flat(params), _flat(stats)),
                               strict=True)
    want = jax_block.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x_nhwc), train=False)
    return want, port_block.eval()


def _encoder_state(params, stats):
    """An encoder's flax variables -> the port encoder's state_dict."""
    sd = block_state_dict({k: v for k, v in _flat(params).items()
                           if k.startswith("trunk/")}, _flat(stats))
    heads = params["emb_features"]["kernel"], params["emb_cnn_code"]
    sd["emb_features.weight"] = torch.from_numpy(np.ascontiguousarray(
        heads[0].transpose(3, 2, 0, 1)))
    sd["emb_cnn_code.weight"] = torch.from_numpy(np.ascontiguousarray(
        heads[1]["kernel"].T))
    sd["emb_cnn_code.bias"] = torch.from_numpy(heads[1]["bias"])
    return sd


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


BLOCKS = {
    "basic_conv": (lambda: jcnn.BasicConv2d(24, (3, 3), strides=2, padding=1),
                   lambda: tcnn.BasicConv2d(16, 24, kernel_size=3, stride=2,
                                            padding=1), 16, 9),
    "inception_a": (lambda: jcnn.InceptionA(32),
                    lambda: tcnn.InceptionA(192, 32), 192, 5),
    "inception_b": (lambda: jcnn.InceptionB(),
                    lambda: tcnn.InceptionB(288), 288, 7),
    "inception_c": (lambda: jcnn.InceptionC(128),
                    lambda: tcnn.InceptionC(768, 128), 768, 5),
    "inception_d": (lambda: jcnn.InceptionD(),
                    lambda: tcnn.InceptionD(768), 768, 7),
    "inception_e": (lambda: jcnn.InceptionE(),
                    lambda: tcnn.InceptionE(1280), 1280, 3),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(rng, name):
    make_jax, make_port, ch, hw = BLOCKS[name]
    x = rng.standard_normal((2, hw, hw, ch)).astype(np.float32)
    want, port = _jax_and_port(make_jax(), make_port(), x, rng)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    folded = tcnn.freeze_trunk(torch.nn.Sequential(port))   # BN folded
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(folded(_nchw(x))), np.asarray(want),
                                   **TOL)


@pytest.mark.parametrize("size,src", [(299, 256), (68, 256), (68, 64)],
                         ids=["up_to_299", "down_to_68", "up_to_68"])
def test_bilinear_resize_matches_jax_image_resize(rng, size, src):
    x = rng.standard_normal((2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear")
    got = tcnn.resize_bilinear(_nchw(x), size)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("res", [64, 96])
def test_tiny_encoder_matches_jax(rng, res):
    x = (rng.standard_normal((2, res, res, 3)) * 0.5).astype(np.float32)
    jax_enc = jcnn.TinyCNNEncoder(out_dim=16, width=8)
    variables = jax.eval_shape(lambda: jax_enc.init(
        jax.random.key(0), jnp.asarray(x), train=False))
    params = _draw(variables["params"], rng)
    want_r, want_c = jax_enc.apply({"params": params}, jnp.asarray(x))
    port = tcnn.TinyCNNEncoder(out_dim=16, width=8)
    port.load_state_dict(_encoder_state(params, {}), strict=True)
    with torch.no_grad():
        got_r, got_c = port(torch.from_numpy(x))
    assert got_r.shape == (2, 289, 16) and got_c.shape == (2, 16)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)


def test_freeze_trunk_keeps_the_eval_function_and_the_trunk(rng):
    trunk = tcnn.TinyTrunk(8)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(
        np.float32))
    with torch.no_grad():
        want = trunk(x)
        got = tcnn.freeze_trunk(trunk)(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert all(p.requires_grad for p in trunk.parameters())


def test_full_width_encoder_has_the_jax_parameter_count():
    enc = tcnn.CNNEncoder(out_dim=256)
    params = sum(p.numel() for p in enc.parameters())
    stats = sum(b.numel() for b in enc.buffers())
    x = jnp.zeros((1, 299, 299, 3))
    shapes = jax.eval_shape(lambda: jcnn.CNNEncoder(out_dim=256).init(
        jax.random.key(0), x, train=False))
    count = lambda t: sum(np.prod(v.shape) for v in jax.tree.leaves(t))
    assert (params, stats) == (count(shapes["params"]),
                               count(shapes["batch_stats"]))


def test_inception_encoder_matches_jax_end_to_end(rng):
    x = (rng.standard_normal((1, 256, 256, 3)) * 0.5).astype(np.float32)
    jax_enc = jcnn.CNNEncoder(out_dim=32)
    variables = jax.eval_shape(lambda: jax_enc.init(
        jax.random.key(0), jnp.asarray(x), train=False))
    params = _draw(variables["params"], rng)
    stats = _draw(variables["batch_stats"], rng)
    want_r, want_c = jax.jit(jax_enc.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = tcnn.CNNEncoder(out_dim=32)
    port.load_state_dict(_encoder_state(params, stats), strict=True)
    with torch.no_grad():
        got_r, got_c = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
