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

import attngan_tpu.models.cnn_encoder as jax_cnn
from attngan_tpu.core.config import GanConfig as JaxGanConfig
from attngan_tpu.models.generator import Generator as JaxGenerator
from attngan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer
from test_torch_port_gan_trainer import _jax_draws, flatten_gan_state

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import (
    _generator_key,
    _generator_value,
    block_state_dict,
    convert_gan_flat,
    load_gan_flat,
)
from attngan_torch.core.config import GanConfig
from attngan_torch.models.cnn_encoder import InceptionV3Trunk, freeze_trunk
from attngan_torch.models.generator import Generator
from attngan_torch.train.gan_trainer import GanTrainer

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


def _assert_within_drift(got, want, fp32, what):
    """The bar: |port - JAX bf16| no larger than |JAX bf16 - JAX fp32|, in
    max and in mean."""
    err, drift = np.abs(got - want), np.abs(want - fp32)
    assert err.max() <= drift.max() and err.mean() <= drift.mean(), \
        (what, err.max(), drift.max(), err.mean(), drift.mean())


# ---- the frozen Inception-v3 trunk in bf16

TRUNK_RES = 64


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_trunk(variables, x, dtype):
    trunk = jax_cnn.InceptionV3Trunk(dtype=dtype)
    out = jax.jit(lambda v, x: trunk.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return [np.asarray(o, np.float32) for o in out]


def test_bf16_frozen_trunk_matches_jax():
    """``freeze_trunk``'s bf16 trunk (every conv with its BN folded into
    bf16 weights and an added bias) against JAX's bf16 eval trunk (a
    mul-add after each bf16 conv, folded weights only for the fused
    sibling convs), batch 1, the same seeded weights and statistics through
    the converter; the regions (17 x 17 x 768) and the pooled code (2048).

    Measured on a CPU (torch 2.13, one thread, as under the tier's
    workers), port against JAX's bf16 beside JAX's bf16 against its fp32:
    on average 3.5e-4 against 3.6e-4 on the regions and 2.3e-4 against
    2.9e-4 on the code (the bar, in mean); at most 0.0078 against 0.0068
    on the regions and 0.0039 against 0.0044 on the code. The regions' max
    does not meet the bar: there the two bf16 results round one element to
    values two bf16 steps apart (a difference of two bf16 results counts
    whole steps, 2^-8 at values in [0.5, 1)): 0.5859 and 0.5781 about the
    fp32 value 0.5822, to which the port's result lies closer than JAX's
    does. The port folds every BN, JAX only its fused siblings' (a rounding
    order JAX does not keep itself), so the max of that difference is not
    asserted. The port's bf16 is held instead to lie no farther from JAX's
    fp32 than JAX's bf16 does, in max and in mean: 0.0042 / 2.8e-4
    against 0.0068 / 3.6e-4 on the regions, 0.0041 / 2.4e-4 against
    0.0044 / 2.9e-4 on the code.
    """
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, TRUNK_RES, TRUNK_RES, 3)) * 0.5).astype(
        np.float32)
    shapes = jax.eval_shape(lambda: jax_cnn.InceptionV3Trunk().init(
        jax.random.key(0), jnp.asarray(x), train=False))
    params = _draw(shapes["params"], rng)
    stats = _draw(shapes["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}
    want = _jax_trunk(variables, x, jnp.bfloat16)
    fp32 = _jax_trunk(variables, x, None)
    trunk = InceptionV3Trunk(dtype=torch.bfloat16)
    trunk.load_state_dict(block_state_dict(_flat(params), _flat(stats)),
                          strict=True)
    with torch.no_grad():
        regions, pooled = freeze_trunk(trunk)(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert regions.dtype == pooled.dtype == torch.bfloat16
    got = [regions.float().permute(0, 2, 3, 1).numpy(), pooled.float().numpy()]
    for what, g, w, ref in zip(("regions", "code"), got, want, fp32):
        assert g.shape == w.shape, what
        err, drift, own = np.abs(g - w), np.abs(w - ref), np.abs(g - ref)
        assert err.mean() <= drift.mean(), (what, err.mean(), drift.mean())
        assert own.max() <= drift.max() and own.mean() <= drift.mean(), \
            (what, own.max(), drift.max(), own.mean(), drift.mean())


# ---- one GAN step in bf16

GAN_SHAPE = dict(gf_dim=8, df_dim=8, emb_dim=16, cond_dim=4, z_dim=4,
                 seq_len=4, batch_size=2, image_encoder="tiny", num_stages=2)
GAN_VOCAB = 30


def _gan_batch():
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, GAN_VOCAB, (2, 4)).astype(np.int32),
             "lengths": np.array([4, 2], np.int32),
             "class_ids": np.array([0, 1], np.int32)}
    for res in (64, 128):
        batch[f"img{res}"] = np.tanh(
            rng.standard_normal((2, res, res, 3))).astype(np.float32)
    return batch


def _jax_gan_step(dtype):
    """(the flat state before the step, its draws, the metrics, the flat
    state after it) of JAX's step in ``dtype``."""
    cfg = JaxGanConfig(**GAN_SHAPE, compute_dtype=dtype)
    trainer = JaxGanTrainer(cfg, vocab_size=GAN_VOCAB)
    state = jax.jit(trainer.init_state, static_argnums=0)(0)
    before, draws = flatten_gan_state(state), _jax_draws(state, cfg)
    state, metrics = trainer.train_step(
        state, {k: jnp.asarray(v) for k, v in _gan_batch().items()})
    return (before, draws, {k: float(v) for k, v in metrics.items()},
            flatten_gan_state(state))


def _module_parts(module_state: dict, keys) -> dict:
    """{"params": the weights, "stats": the BN statistics} of a module's
    state_dict (or its converted JAX counterpart), each one flat vector."""
    parts = {}
    for part, pick in (("params", lambda k: "running_" not in k),
                       ("stats", lambda k: "running_" in k)):
        chosen = sorted(k for k in keys if pick(k))
        if chosen:
            parts[part] = np.concatenate([
                np.asarray(module_state[k], np.float32).ravel()
                for k in chosen])
    return parts


def test_bf16_gan_step_matches_jax():
    """One GAN step in bf16, the port's against JAX's: the tiny encoder, 2
    stages (no DAMSM coupling: it starts at 256^2), gf and df 8, batch 2,
    from JAX's initial state through the converter, with JAX's draws on the
    state's key (tests/test_torch_port_gan_trainer.py's). Measured on a CPU
    (torch 2.13, one thread), port against JAX's bf16 beside JAX's bf16
    against its fp32 step: the metrics differ by 0.0070 at most and 0.0030
    on average, against 0.0279 and 0.0124; the parameters of the generator
    and both discriminators by 2 lr at most in both comparisons (Adam's
    first step moves each weight by about +-lr, so an element whose
    gradient takes the other sign moves 2 lr the other way), and on
    average by 3.5e-5, 6.0e-6 and 1.4e-5 against 4.6e-5, 8.6e-6 and
    1.9e-5; the BN statistics by 0.0042, 0.0014 and 0.0034 at most against
    0.0051, 0.0028 and 0.0043, and by 1.4e-4, 3.0e-4 and 5.2e-4 on average
    against 2.1e-4, 5.1e-4 and 7.7e-4."""
    before, draws, want_metrics, after = _jax_gan_step("bfloat16")
    before32, _, fp32_metrics, after32 = _jax_gan_step("")
    assert all(np.array_equal(before[k], before32[k]) for k in before)
    trainer = GanTrainer(GanConfig(**GAN_SHAPE, compute_dtype="bfloat16"),
                         GAN_VOCAB, device="cpu")
    state = trainer.init_state(seed=1)
    load_gan_flat(before, state)
    state, metrics = trainer.train_step(state, _gan_batch(), **draws)
    assert set(metrics) == set(want_metrics)
    names = sorted(want_metrics)
    _assert_within_drift(np.array([float(metrics[k]) for k in names]),
                         np.array([want_metrics[k] for k in names]),
                         np.array([fp32_metrics[k] for k in names]),
                         "metrics")
    want, want32 = convert_gan_flat(after), convert_gan_flat(after32)
    modules = {"gen": (state.gen, want["generator"], want32["generator"]),
               **{res: (d, want["discs"][res], want32["discs"][res])
                  for res, d in state.discs.items()}}
    assert set(modules) == {"gen", "64", "128"}
    for who, (module, ref, ref32) in modules.items():
        got = module.state_dict()
        assert set(got) == set(ref)
        keys = [k for k in ref if not k.endswith("num_batches_tracked")]
        parts = _module_parts({k: v.float() for k, v in got.items()}, keys)
        want_parts = _module_parts(ref, keys)
        fp32_parts = _module_parts(ref32, keys)
        for part in parts:
            _assert_within_drift(parts[part], want_parts[part],
                                 fp32_parts[part], f"{who} {part}")
