"""The generator in bf16, the dtype serving and the GAN step run by default,
against the JAX package's bf16 generator, on the CPU.

Both take the same weights (the JAX init's shapes, drawn with numpy and
converted), noise, eps, words and mask; a 2-stage generator at gf 8, emb
32, batch 2. Measured on a CPU (torch 2.13, jax with "highest"
precision): in eval mode (serving) the images differ by at most 0.0032
(64^2) and 0.0107 (128^2), 4.4e-4 and 1.3e-3 on average, on tanh outputs
in [-1, 1] whose bf16 step at 1 is 2^-8; each package's own bf16 drift
from its fp32 output is the same size (0.0114 max for JAX). Bars: 2^-6
max (four bf16 steps at 1) and 2^-9 mean. In train mode the batch
statistics of 2 images amplify every rounding difference (the port and
JAX differ by up to 0.131 at 128^2, while JAX's own bf16 lies up to 0.256
from its fp32), so there the bar is that drift: the port's bf16 lies no
farther from JAX's bf16, in max and in mean, than JAX's bf16 lies from
JAX's fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.models.generator import Generator as JaxGenerator

from attngan_torch.convert import _generator_key, _generator_value
from attngan_torch.core.config import GanConfig
from attngan_torch.models.generator import Generator

B, L, E, GF = 2, 5, 32, 8
EVAL_MAX, EVAL_MEAN = 2.0 ** -6, 2.0 ** -9


def _draw(tree, rng):
    def draw(path, x):
        name, shape = path[-1], x.shape
        if name in ("var", "scale"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ("mean", "bias"):
            a = rng.standard_normal(shape) * 0.1
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return a.astype(np.float32)
    flat = traverse_util.flatten_dict(tree)
    return traverse_util.unflatten_dict({k: draw(k, v)
                                         for k, v in flat.items()})


@pytest.fixture(scope="module")
def inputs():
    cfg = GanConfig(gf_dim=GF, emb_dim=E, seq_len=L, num_stages=2)
    gen = JaxGenerator(gf_dim=GF, emb_dim=E, z_dim=cfg.z_dim,
                       cond_dim=cfg.cond_dim, num_stages=2)
    shapes = jax.eval_shape(lambda: gen.init(
        jax.random.key(2), jnp.zeros((B, cfg.z_dim)), jnp.zeros((B, E)),
        jnp.zeros((B, L, E)), jnp.ones((B, L), jnp.int32),
        jax.random.key(3), train=False))
    rng = np.random.default_rng(0)
    mask = np.ones((B, L), np.int32)
    mask[1, 3:] = 0
    return dict(
        params=_draw(shapes["params"], rng),
        stats=_draw(shapes["batch_stats"], rng),
        noise=rng.standard_normal((B, cfg.z_dim)).astype(np.float32),
        eps=rng.standard_normal((B, cfg.cond_dim)).astype(np.float32),
        words=rng.standard_normal((B, L, E)).astype(np.float32),
        sent=rng.standard_normal((B, E)).astype(np.float32), mask=mask,
        cfg=cfg)


def _jax_images(s, dtype, train):
    gen = JaxGenerator(gf_dim=GF, emb_dim=E, z_dim=s["cfg"].z_dim,
                       cond_dim=s["cfg"].cond_dim, num_stages=2, dtype=dtype)
    eps = jnp.asarray(s["eps"])
    real_normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: eps.astype(dtype)
    try:
        out = gen.apply({"params": s["params"], "batch_stats": s["stats"]},
                        jnp.asarray(s["noise"]), jnp.asarray(s["sent"]),
                        jnp.asarray(s["words"]), jnp.asarray(s["mask"]),
                        jax.random.key(0), train=train,
                        mutable=("batch_stats",) if train else False)
    finally:
        jax.random.normal = real_normal
    fakes = out[0][0] if train else out[0]
    return [np.asarray(f, np.float32) for f in fakes]


def _port_images(s, train):
    gen = Generator.from_config(GanConfig(
        gf_dim=GF, emb_dim=E, seq_len=L, num_stages=2,
        compute_dtype="bfloat16"))
    sd = {}
    for tree in ("params", "stats"):
        for path, v in traverse_util.flatten_dict(s[tree], sep="/").items():
            sd[_generator_key(path)] = _generator_value(path, np.asarray(v))
    gen.load_state_dict(sd, strict=True)
    gen.train(train)
    with torch.no_grad():
        fakes, _, _, _ = gen(*(torch.as_tensor(s[k]) for k in
                               ("noise", "sent", "words", "mask")),
                             eps=torch.as_tensor(s["eps"]))
    return [f.float().numpy() for f in fakes]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_bn"])
def test_bf16_generator_matches_jax(inputs, train):
    got = _port_images(inputs, train)
    want = _jax_images(inputs, jnp.bfloat16, train)
    assert [g.shape for g in got] == [(B, 64, 64, 3), (B, 128, 128, 3)]
    if not train:
        for res, g, w in zip((64, 128), got, want):
            err = np.abs(g - w)
            assert err.max() <= EVAL_MAX and err.mean() <= EVAL_MEAN, \
                (res, err.max(), err.mean())
        return
    fp32 = _jax_images(inputs, None, train)
    for res, g, w, ref in zip((64, 128), got, want, fp32):
        err, drift = np.abs(g - w), np.abs(w - ref)
        assert err.max() <= drift.max() and err.mean() <= drift.mean(), \
            (res, err.max(), drift.max(), err.mean(), drift.mean())
