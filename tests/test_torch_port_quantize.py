"""The port's int8 tier (attngan_torch/infer/quantize.py, ops/int8.py)
against attngan_tpu/infer/quantize.py, and the int8 trunk of the DAMSM step
against JAX's ``trunk_int8``.

Weights are the JAX modules' (randomized with numpy, as in
tests/test_torch_port_models.py), converted; noise and eps are drawn once
and handed to both (jax.random.normal is replaced by the test's draws).
Both run in fp32 on the CPU.

Tolerances:
- The histogram percentile and the calibration records: 1e-5 relative.
  Both sides bin the same fp32 values (the port's within ~1e-7 of JAX's)
  into the same 2048 bins; a record is a max or a bin edge.
- One quantized site given the same scale: 1e-6 relative, 1e-6 absolute.
  The s32 products are exact on both sides; only the fp32 dequantize and
  bias add round (XLA may fuse them).
- Images of the int8 sampler with JAX's scales, on [0, 1]: at least 90%
  of the elements within 1e-5 of JAX's, all within 1e-2, the mean within
  1e-4. A site's input differs from JAX's by float rounding (~1e-7),
  which flips round(x / sx) for the rare element within that of a half
  step; a flip moves one element's product by a quantization step, and the
  later convs and upsamplings spread it over a patch (observed: 97.8%
  within 1e-5, the max 3.3e-3, the mean 1.1e-5). The float path is far
  outside: 0.5% within 1e-5, the mean 1.6e-3.
- The int8 trunk's DAMSM steps: the scales at 1e-5 relative, the losses
  at 5e-5 relative over 4 steps against JAX's own int8 step (the flips
  above, in the trunk's features, carried into the loss; observed 2e-6,
  while the float step's losses lie 2.3e-4 from the int8 step's), and
  within JAX's own bound of 5% of the float step.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util
from test_torch_port_damsm_trainer import flatten_damsm_state
from test_torch_port_models import _draw, _flat
import torch_threads  # noqa: F401  (torch threads under xdist)
from torch_parallel_ranks import int8_job, run_ranks

from attngan_tpu.core.config import DamsmConfig as JaxDamsmConfig
from attngan_tpu.infer import quantize as jax_quantize
from attngan_tpu.infer.sampler import InferState as JaxInferState
from attngan_tpu.models.cnn_encoder import BasicConv2d as JaxBasicConv2d
from attngan_tpu.models.cnn_encoder import InceptionV3Trunk as JaxInception
from attngan_tpu.models.cnn_encoder import TinyTrunk as JaxTinyTrunk
from attngan_tpu.models.generator import Generator as JaxGenerator
from attngan_tpu.models.rnn_encoder import BiLSTMEncoder as JaxBiLSTM
from attngan_tpu.train.damsm_trainer import DamsmTrainer as JaxDamsmTrainer

from attngan_torch.cli import infer, pretrain
from attngan_torch.convert import (
    _generator_key,
    block_state_dict,
    load_damsm_flat,
    load_flat,
)
from attngan_torch.core.config import DamsmConfig, GanConfig
from attngan_torch.infer.quantize import (
    Int8Sampler,
    abs_percentile,
    calibrate,
    generator_sites,
    quantized_call,
    trunk_sites,
)
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.cnn_encoder import BasicConv2d, InceptionV3Trunk
from attngan_torch.models.generator import Generator
from attngan_torch.ops.int8 import Int8Site, intercept
from attngan_torch.train.damsm_trainer import DamsmTrainer

B, L, VOCAB = 3, 4, 30
CFG = GanConfig(gf_dim=8, emb_dim=32, z_dim=12, cond_dim=10, seq_len=L,
                num_stages=2, compute_dtype="float32")
SCALE_RTOL = 1e-5
SITE_TOL = dict(rtol=1e-6, atol=1e-6)
IMAGE_TOL = dict(share_within_1e5=0.9, atol=1e-2, mean=1e-4)
LOSS_RTOL = 5e-5


# ---------------------------------------------------------------- helpers

@pytest.fixture(scope="module")
def gen_state():
    """JAX's (trainer stand-in, InferState), the port's InferState with
    the same weights, and the batch, noise and eps."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (B, L)).astype(np.int32)
    lengths = np.array([L, 2, 3], np.int32)
    rnn = JaxBiLSTM(vocab_size=VOCAB, hidden_dim=CFG.emb_dim)
    gen = JaxGenerator(gf_dim=CFG.gf_dim, emb_dim=CFG.emb_dim,
                       z_dim=CFG.z_dim, cond_dim=CFG.cond_dim,
                       num_stages=CFG.num_stages)
    rnn_params = jax.eval_shape(lambda: rnn.init(
        jax.random.key(1), tokens, lengths, train=False))["params"]
    gvars = jax.eval_shape(lambda: gen.init(
        jax.random.key(2), jnp.zeros((B, CFG.z_dim)),
        jnp.zeros((B, CFG.emb_dim)), jnp.zeros((B, L, CFG.emb_dim)),
        jnp.ones((B, L), jnp.int32), jax.random.key(3), train=False))
    weights = dict(rnn_params=_draw(rnn_params, rng),
                   gen_params=_draw(gvars["params"], rng),
                   gen_stats=_draw(gvars["batch_stats"], rng))
    port = InferState(CFG, VOCAB)
    load_flat(_flat(weights["rnn_params"], weights["gen_params"],
                    weights["gen_stats"]), port.rnn, port.generator)
    trainer = types.SimpleNamespace(cfg=CFG, rnn=rnn, generator=gen)
    return dict(trainer=trainer, jax=JaxInferState(**weights), port=port,
                tokens=tokens, lengths=lengths,
                noise=rng.standard_normal((B, CFG.z_dim)).astype(np.float32),
                eps=rng.standard_normal((B, CFG.cond_dim)).astype(np.float32))


def _with_draws(s, fn):
    """fn() with jax.random.normal returning the test's noise or eps (by
    their widths, which differ)."""
    real = jax.random.normal
    draws = {CFG.z_dim: jnp.asarray(s["noise"]),
             CFG.cond_dim: jnp.asarray(s["eps"])}
    jax.random.normal = lambda key, shape, dtype=jnp.float32: \
        draws[shape[-1]].astype(dtype)
    try:
        return fn()
    finally:
        jax.random.normal = real


def _jax_int8(s, percentile, scales=None):
    """JAX's Int8Sampler on the test's batch: (scales, images)."""
    sampler = jax_quantize.Int8Sampler(s["trainer"], s["jax"],
                                       percentile=percentile)
    if scales is not None:
        sampler.act_scales = dict(scales)
    imgs = _with_draws(s, lambda: np.asarray(sampler.generate_from_tokens(
        jnp.asarray(s["tokens"]), jnp.asarray(s["lengths"]),
        jax.random.key(0))))
    return sampler.act_scales, imgs


def _port_int8(s, percentile=99.0, **kw):
    return Int8Sampler(s["port"], device="cpu", percentile=percentile, **kw)


def _draws(s):
    return torch.from_numpy(s["noise"]), torch.from_numpy(s["eps"])


def _assert_images_close(got, want):
    diff = np.abs(got - want)
    assert (diff <= 1e-5).mean() >= IMAGE_TOL["share_within_1e5"]
    assert diff.max() <= IMAGE_TOL["atol"]
    assert diff.mean() <= IMAGE_TOL["mean"]


# ---------------------------------------------------------- the percentile

@pytest.mark.parametrize("n,pct", [(100_000, 99.0), ((1 << 22) + 12_345, 99.9)],
                         ids=["one_chunk", "past_2^22"])
def test_abs_percentile_matches_jax(n, pct):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 2.0, n)).astype(np.float32)
    x[:5] = [40.0, -35.0, 30.0, 25.0, -20.0]            # spikes stretch the max
    want = float(jax_quantize._abs_percentile(jnp.asarray(x), pct))
    got = float(abs_percentile(torch.from_numpy(x), pct))
    assert got == pytest.approx(want, rel=SCALE_RTOL)
    assert got < 0.5 * float(np.abs(x).max())           # the spikes clipped


# -------------------------------------------------------------- the sites

def _jax_record_keys(module, *args, **kwargs):
    """The paths JAX's calibrate() records for module.apply, from a trace
    only (eval_shape: nothing is computed)."""
    def run():
        variables = module.init(jax.random.key(0), *args, **kwargs)
        return jax_quantize.calibrate(module.apply, variables, *args,
                                      **kwargs)[1]
    return set(jax.eval_shape(run))


@pytest.mark.parametrize("model", ["generator", "inception", "tiny"])
def test_sites_are_jax_sites(model):
    """Key for key, the sites JAX's interceptor reaches: the full-width
    3-stage generator (not the UpBlocks' convs), the Inception trunk
    (65 of its 94 convs: not the 29 fused siblings) and the tiny trunk."""
    if model == "generator":
        cfg = GanConfig()
        gen = JaxGenerator()
        want = _jax_record_keys(
            gen, jnp.zeros((2, cfg.z_dim)), jnp.zeros((2, cfg.emb_dim)),
            jnp.zeros((2, cfg.seq_len, cfg.emb_dim)),
            jnp.ones((2, cfg.seq_len), jnp.int32), jax.random.key(1),
            train=False)
        port = Generator.from_config(cfg)
        sites = generator_sites(port)
        names = {m: n for n, m in port.named_modules()}
        for layer, path in sites.items():     # the converter's own mapping
            assert _generator_key(path + "/kernel") == names[layer] + ".weight"
        assert len(sites) == 15
    elif model == "inception":
        want = _jax_record_keys(JaxInception(), jnp.zeros((1, 75, 75, 3)),
                                train=False)
        trunk = InceptionV3Trunk()
        sites = trunk_sites(trunk)
        convs = [m for m in trunk.modules() if isinstance(m, BasicConv2d)]
        assert (len(convs), len(sites)) == (94, 65)
        names = {m: n for n, m in trunk.named_modules()}
        for layer, path in sites.items():
            assert names[layer] == path.replace("/", ".")
    else:
        want = _jax_record_keys(JaxTinyTrunk(width=8),
                                jnp.zeros((1, 32, 32, 3)))
        sites = trunk_sites(DamsmTrainer(
            DamsmConfig(image_encoder="tiny", emb_dim=16), VOCAB, L,
            device="cpu").init_state(0).cnn.trunk)
    assert set(sites.values()) == want


# ----------------------------------------------- one site, the same scale

def _site_case(name, rng):
    """(flax module, its variables, the port layer with its weights, the
    JAX input NHWC / (..., K), the site's path: "" is the applied module's
    own)."""
    if name == "dense":
        mod = fnn.Dense(12, name="d")
        x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    elif name == "basic_conv2d":
        mod = JaxBasicConv2d(24, (3, 3), strides=2, padding=1, name="b")
        x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    else:
        kernel, stride, pad, bias = {
            "conv3x3_bias": ((3, 3), 1, 1, True),
            "conv1x7_stride2": ((1, 7), 2, ((0, 0), (3, 3)), False)}[name]
        mod = fnn.Conv(12, kernel, strides=stride, padding=pad,
                       use_bias=bias, name="c")
        x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    variables = _draw(jax.eval_shape(
        lambda: mod.init(jax.random.key(0), jnp.asarray(x))), rng)
    flat = traverse_util.flatten_dict(variables["params"], sep="/")
    if name == "dense":
        layer = torch.nn.Linear(16, 12)
        layer.weight.data = torch.from_numpy(flat["kernel"].T.copy())
        layer.bias.data = torch.from_numpy(flat["bias"])
        return mod, variables, layer, x, ""
    if name == "basic_conv2d":
        layer = BasicConv2d(8, 24, kernel_size=3, stride=2, padding=1).eval()
        stats = traverse_util.flatten_dict(variables["batch_stats"], sep="/")
        layer.load_state_dict(block_state_dict(flat, stats))
        return mod, variables, layer, x, "conv"
    w = flat["kernel"]
    layer = torch.nn.Conv2d(3, 12, kernel, stride=stride, bias=bias,
                            padding=(pad, pad) if isinstance(pad, int)
                            else tuple(p[0] for p in pad))
    layer.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    if bias:
        layer.bias.data = torch.from_numpy(flat["bias"])
    return mod, variables, layer, x, ""


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["conv3x3_bias", "conv1x7_stride2", "dense",
                                  "basic_conv2d"])
def test_a_quantized_site_matches_jax(name):
    """conv / dense given the same scale; BasicConv2d: the raw kernel
    quantized, then BN and relu in float (JAX's order)."""
    mod, variables, layer, x, path = _site_case(name, np.random.default_rng(2))
    scale = 0.8 * float(np.abs(x).max())          # clips the largest inputs
    kw = {"train": False} if name == "basic_conv2d" else {}
    want = np.asarray(jax_quantize.quantized_call(
        {path: scale}, mod.apply, variables, jnp.asarray(x), **kw))
    if name == "basic_conv2d":
        got = quantized_call({path: scale}, layer, _nchw(x),
                             sites={layer.conv: path})
    else:
        site = Int8Site(layer)
        got = site(torch.from_numpy(x) if name == "dense" else _nchw(x),
                   scale / 127.0)
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **SITE_TOL)
    float_out = mod.apply(variables, jnp.asarray(x), **kw)
    assert not np.allclose(want, np.asarray(float_out), atol=1e-6)


def test_skipped_grouped_and_uncalibrated_sites_stay_float(gen_state):
    s = gen_state
    rng = np.random.default_rng(3)
    grouped = torch.nn.Conv2d(8, 8, 3, padding=1, groups=4)
    dilated = torch.nn.Conv2d(8, 8, 3, padding=2, dilation=2)
    x = torch.from_numpy(rng.standard_normal((1, 8, 6, 6)).astype(np.float32))
    for conv in (grouped, dilated):
        sites = {conv: "g"}

        def fn():
            out = intercept(conv, x)
            return conv(x) if out is None else out
        _, records = calibrate(fn, sites=sites)
        assert records == {}
        assert torch.equal(quantized_call({"g": 1.0}, fn, sites=sites),
                           conv(x))
    noise, eps = _draws(s)
    want = Sampler(s["port"], device="cpu").generate_from_tokens(
        s["tokens"], s["lengths"], noise, eps)
    every = tuple(generator_sites(s["port"].generator).values())
    skipped = _port_int8(s, skip=every).generate_from_tokens(
        s["tokens"], s["lengths"], noise, eps)
    assert torch.equal(skipped, want)
    uncalibrated = _port_int8(s)
    uncalibrated.act_scales = uncalibrated.quantizer.act_scales = {}
    assert torch.equal(uncalibrated.generate_from_tokens(
        s["tokens"], s["lengths"], noise, eps), want)


# ---------------------------------------------------------- the sampler

@pytest.mark.parametrize("percentile", [100.0, 99.0])
def test_calibration_records_match_jax(gen_state, percentile):
    s = gen_state
    want, _ = _jax_int8(s, percentile)
    got = _port_int8(s, percentile).calibrate_on(s["tokens"], s["lengths"],
                                                 *_draws(s))
    assert list(got) == sorted(want)
    for path, value in want.items():
        assert got[path] == pytest.approx(value, rel=SCALE_RTOL), path


def test_int8_sampler_matches_jax_with_its_scales(gen_state):
    s = gen_state
    scales, want = _jax_int8(s, 99.0)
    sampler = _port_int8(s)
    sampler.act_scales = sampler.quantizer.act_scales = scales
    noise, eps = _draws(s)
    got = sampler.generate_from_tokens(s["tokens"], s["lengths"], noise, eps)
    _assert_images_close(got.numpy(), want)
    float_imgs = Sampler(s["port"], device="cpu").generate_from_tokens(
        s["tokens"], s["lengths"], noise, eps)
    assert float((got - float_imgs).abs().max()) > 0     # int8 did act
    # calibrated on its first batch, with that batch's own draws; the
    # scales kept for the next call
    fresh = _port_int8(s)
    first = fresh.generate_from_tokens(
        s["tokens"], s["lengths"], generator=torch.Generator().manual_seed(4))
    again = fresh.generate_from_tokens(
        s["tokens"], s["lengths"], generator=torch.Generator().manual_seed(4))
    assert fresh.act_scales and torch.equal(first, again)


def test_ranks_calibrate_to_one_process(gen_state, tmp_path):
    """2 gloo ranks: the sampler's p99 scales (maxima MAX, counts SUM over
    the ranks) and the trunk's max scales equal one process's."""
    s = gen_state
    weights = {k: v.numpy() for k, v in s["port"].state_dict().items()}
    rng = np.random.default_rng(5)
    kwargs = dict(cfg=dataclasses.asdict(CFG), vocab=VOCAB,
                  tokens=np.tile(s["tokens"], (2, 1))[:4],
                  lengths=np.tile(s["lengths"], 2)[:4], weights=weights,
                  noise=rng.standard_normal((4, CFG.z_dim)).astype(np.float32),
                  eps=rng.standard_normal((4, CFG.cond_dim)).astype(np.float32),
                  img=(rng.standard_normal((4, 32, 32, 3)) * 0.5).astype(
                      np.float32))
    one = int8_job(None, **kwargs)
    for rank in run_ranks(2, [("int8", (2,), kwargs)]):
        got = rank[0]
        for key in ("scales", "trunk_scales"):
            assert list(got[key]) == list(one[key])
            for path, value in one[key].items():
                assert got[key][path] == pytest.approx(value, rel=SCALE_RTOL)
        _assert_images_close(got["images"], one["images"])


# ------------------------------------------------------------ the trunk

DAMSM = dict(emb_dim=32, text_emb_dim=16, batch_size=4, image_encoder="tiny",
             compute_dtype="", dropout=0.0)


def _damsm_batch():
    rng = np.random.default_rng(6)
    return {"tokens": rng.integers(0, VOCAB, (4, 5)).astype(np.int32),
            "lengths": np.array([5, 3, 4, 2], np.int32),
            "class_ids": np.array([0, 1, 2, 3], np.int32),
            "img256": (rng.standard_normal((4, 32, 32, 3)) * 0.5).astype(
                np.float32)}


def test_trunk_int8_steps_match_jax():
    """4 steps of the int8-trunk DAMSM step from JAX's state: the scales,
    each loss against JAX's int8 step, and JAX's own 5% bound against the
    float step."""
    batch = _damsm_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = {}
    for flag in (False, True):
        jt = JaxDamsmTrainer(JaxDamsmConfig(trunk_int8=flag, **DAMSM), VOCAB,
                             5, image_res=32)
        js = jt.init_state(seed=0)
        flat = flatten_damsm_state(js)
        pt = DamsmTrainer(DamsmConfig(trunk_int8=flag, **DAMSM), VOCAB, 5,
                          device="cpu")
        ps = pt.init_state(seed=1)
        load_damsm_flat(flat, ps)
        for _ in range(4):
            js, jm = jt.train_step(js, jbatch)
            ps, pm = pt.train_step(ps, batch)
            losses.setdefault(flag, []).append((float(jm["loss"]),
                                                float(pm["loss"])))
        if flag:
            want = dict(jt._trunk_scales)
            assert list(pt._trunk_scales) == sorted(want) == \
                ["Conv_0", "Conv_1", "Conv_2"]
            for path, value in want.items():
                assert pt._trunk_scales[path] == pytest.approx(
                    value, rel=SCALE_RTOL)
    for (jax_f, port_f), (jax_q, port_q) in zip(losses[False], losses[True]):
        assert port_q == pytest.approx(jax_q, rel=LOSS_RTOL)
        assert abs(port_q - port_f) / abs(port_f) < 0.05
    assert losses[True][-1][1] < losses[True][0][1]


def test_trunk_int8_superbatch_matches_jax():
    """The superbatch step under trunk_int8 (one int8 trunk forward at 2 x
    4 rows, calibrated on them, then 2 steps) against JAX's."""
    batch = _damsm_batch()
    two = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    cfg = dict(DAMSM, trunk_int8=True, superbatch=2)
    jt = JaxDamsmTrainer(JaxDamsmConfig(**cfg), VOCAB, 5, image_res=32)
    js = jt.init_state(seed=0)
    pt = DamsmTrainer(DamsmConfig(**cfg), VOCAB, 5, device="cpu")
    ps = pt.init_state(seed=1)
    load_damsm_flat(flatten_damsm_state(js), ps)
    _, jm = jt.train_step_super(js, {k: jnp.asarray(v) for k, v in
                                     two.items()})
    _, pm = pt.train_step_super(ps, two)
    np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=LOSS_RTOL)
    want = dict(jt._trunk_scales)
    for path, value in want.items():
        assert pt._trunk_scales[path] == pytest.approx(value, rel=SCALE_RTOL)


def test_inception_trunk_int8_step():
    """The Inception trunk in int8 at batch 2: 65 sites calibrated once,
    the step's loss within JAX's 5% of the float step's."""
    cfg = DamsmConfig(emb_dim=16, text_emb_dim=8, batch_size=2,
                      compute_dtype="", dropout=0.0, image_encoder="inception_v3")
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, VOCAB, (2, 5)).astype(np.int32),
             "lengths": np.array([5, 3], np.int32),
             "class_ids": np.array([0, 1], np.int32),
             "img256": (rng.standard_normal((2, 64, 64, 3)) * 0.5).astype(
                 np.float32)}
    loss = {}
    for flag in (False, True):
        trainer = DamsmTrainer(dataclasses.replace(cfg, trunk_int8=flag),
                               VOCAB, 5, device="cpu")
        state = trainer.init_state(seed=0)
        _, m = trainer.train_step(state, batch)
        loss[flag] = float(m["loss"])
    assert len(trainer._trunk_scales) == 65
    assert abs(loss[True] - loss[False]) / loss[False] < 0.05


# ---------------------------------------------------------------- the CLIs

def _serve_args(tmp_path, stages: int = 2):
    return ["--device", "cpu", "--checkpoint", "", "--gf-dim", "4",
            "--emb-dim", "16", "--seq-len", "4", "--num-stages", str(stages),
            "--captions-path", str(tmp_path / "none.json")]


def test_cli_int8_benchmark_on_the_cpu(tmp_path):
    result = infer.main([*_serve_args(tmp_path, stages=1), "--benchmark",
                         "--batch-size", "2", "--int8"])
    assert result["int8"] is True and result["value"] > 0


def test_cli_int8_writes_images(tmp_path):
    from attngan_torch.data.synthetic import make_synthetic_dataset
    caps = tmp_path / "caps.json"
    make_synthetic_dataset(4).save_captions_and_class_ids(str(caps))
    args = [a if a != str(tmp_path / "none.json") else str(caps)
            for a in _serve_args(tmp_path)]
    paths = infer.main([*args, "--int8", "--image-names", "00000", "00001",
                        "--out", str(tmp_path / "out")])
    assert [os.path.basename(p) for p in paths] == ["00000.png", "00001.png"]


def test_cli_pretrain_trunk_int8_on_the_cpu(tmp_path):
    trainer, state, history = pretrain.main([
        "--synthetic", "8", "--batch-size", "4", "--epochs", "1",
        "--image-encoder", "tiny", "--emb-dim", "16", "--compute-dtype",
        "float32", "--device", "cpu", "--trunk-int8",
        "--captions-path", str(tmp_path / "caps.json"),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--image-dir", str(tmp_path / "img")])
    assert trainer.cfg.trunk_int8 and len(trainer._trunk_scales) == 3
    assert state.step == 2 and all(map(np.isfinite, history))


@pytest.mark.parametrize("flags,message", [
    (["--int8", "--all-stages", "--image-names", "a"], "final-stage path"),
    (["--int8", "--save-attention", "--image-names", "a"], "final-stage path"),
    (["--export", "x.zip", "--fused-upsample", "pallas"], "plain path"),
    (["--export", "x.zip", "--int8", "--export-platforms", "cpu"],
     "empty or missing"),
], ids=["all_stages", "save_attention", "export_kernels", "export_no_caps"])
def test_cli_refusals(tmp_path, flags, message):
    with pytest.raises(SystemExit, match=message):
        infer.main([*_serve_args(tmp_path), *flags])


def test_cli_pretrain_refuses_int8_with_train_mode_bn(tmp_path):
    with pytest.raises(ValueError, match="trunk_train_mode_bn"):
        pretrain.main(["--synthetic", "8", "--batch-size", "4",
                       "--image-encoder", "tiny", "--device", "cpu",
                       "--trunk-int8", "--trunk-train-mode-bn",
                       "--captions-path", str(tmp_path / "c.json"),
                       "--checkpoint-dir", str(tmp_path / "ckpt")])
