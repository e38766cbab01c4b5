"""The port's DAMSM pretrain options against attngan_tpu's DamsmTrainer.

Compared with JAX (the tiny encoder in fp32 with dropout 0 unless stated,
the same weights through attngan_torch.convert.load_damsm_flat from a JAX
DamsmState, as tests/test_torch_port_damsm_trainer.py does):
- the cached step on one numpy cache, after 1 and 3 steps;
- ``precompute_trunk_features``: fp32 at 1e-5, fp16 within one fp16 step
  of that;
- the superbatch step (K = 3): metrics of shape (K,), losses, parameters;
- the constructor's refusals, with JAX's messages;
- the train-mode trunk BN step on the Inception trunk (batch 2, 64^2):
  loss and the moved running statistics;
- the attention maps, every map at 1e-5, with ``limit`` and the ragged drop;
- the cached and superbatch loops' histories;
- ``--pretrained-cnn``: a torchvision-keyed .pth of tests/torch_oracles.py's
  trunk through tools/convert_torch_weights.py, ``load_converted`` and
  JAX's ``init_state(pretrained_cnn=)``, and through the port's flag:
  the same trunk bit for bit, ``encode_image`` at 1e-4 at batch 1.
The port alone: the superbatch equals K plain steps with dropout 0.5 (the
generator drawn in order); an fp32 cache gives the plain step within 1e-5;
the default step leaves the trunk's statistics as they were, and a
train-mode BN step drops the folded trunk it made stale; the CLI runs each
option and refuses what JAX refuses.

Tolerance 1e-4 (relative on the metrics, absolute on parameters and
statistics) unless stated: the same fp32 arithmetic in other summation
orders. The JAX Inception state is built by a jitted ``init_state`` (flax's
eager init of the trunk takes ~40 s on the CPU).
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.core.config import DamsmConfig as JaxDamsmConfig
from attngan_tpu.core.config import RunConfig as JaxRunConfig
from attngan_tpu.data.dataset import Dataset as JaxDataset
from attngan_tpu.data.dataset import Record as JaxRecord
from attngan_tpu.train.checkpoint import load_converted
from attngan_tpu.train.damsm_trainer import DamsmTrainer as JaxDamsmTrainer
from attngan_tpu.train.loops import _group_superbatches as jax_group
from attngan_tpu.train.loops import run_damsm_training as jax_run_damsm
from test_torch_port_damsm_trainer import flatten_damsm_state
from tools import convert_torch_weights
from torch_oracles import TInceptionTrunk, randomize_

from attngan_torch.cli import pretrain
from attngan_torch.convert import (
    convert_damsm_flat,
    load_damsm_flat,
    load_pretrained_trunk,
    torchvision_trunk_state_dict,
)
from attngan_torch.core.config import DamsmConfig, RunConfig
from attngan_torch.data.dataset import Dataset, Record
from attngan_torch.train import loops
from attngan_torch.train.damsm_trainer import DamsmTrainer
from attngan_torch.utils.imaging import read_png

B, L, VOCAB, RES = 4, 5, 30, 64
SHAPE = dict(emb_dim=32, text_emb_dim=16, batch_size=B, image_encoder="tiny",
             compute_dtype="", dropout=0.0)
INCEPTION = dict(SHAPE, emb_dim=16, text_emb_dim=8, batch_size=2,
                 image_encoder="inception_v3")
METRICS = ("loss", "rnn_grad_norm", "words_loss", "sentence_loss")
ATOL = 1e-4
TINY_FEATURES = 128          # the tiny trunk's region and pooled widths


def _batch(seed=3, b=B, res=RES):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, VOCAB, (b, L)).astype(np.int32),
            "lengths": rng.integers(2, L + 1, b).astype(np.int32),
            "class_ids": (np.arange(b) % 3).astype(np.int32),
            "img256": (rng.standard_normal((b, res, res, 3)) * 0.5).astype(
                np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_state(cfg=SHAPE, **kw):
    trainer = JaxDamsmTrainer(JaxDamsmConfig(**{**cfg, **kw}),
                              vocab_size=VOCAB, seq_len=L, image_res=RES)
    return trainer, trainer.init_state(seed=0)


def _port(flat, cfg=SHAPE, **kw):
    trainer = DamsmTrainer(DamsmConfig(**{**cfg, **kw}), VOCAB, L,
                           device="cpu")
    state = trainer.init_state(seed=1)
    load_damsm_flat(flat, state)
    return trainer, state


def _assert_metrics(got, want, rtol=ATOL):
    for k in METRICS:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, err_msg=k)


def _assert_trainable(state, flat, atol=ATOL):
    want = convert_damsm_flat(flat)
    for tree, module in (("rnn", state.rnn), ("cnn", state.cnn)):
        got = module.state_dict()
        for k, v in want[tree].items():
            if tree == "rnn" or not k.startswith("trunk."):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                           atol=atol, err_msg=k)
    assert state.step == want["step"]


# ---- the cached step

def _cache(n=B, seed=11):
    rng = np.random.default_rng(seed)
    return {"trunk_regions": rng.uniform(0, 2, (n, 289, TINY_FEATURES)
                                         ).astype(np.float16),
            "trunk_pooled": rng.uniform(0, 2, (n, TINY_FEATURES)
                                        ).astype(np.float16)}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_cached_steps_match_jax(fused):
    jax_trainer, jax_state = _jax_state()
    batch = {**{k: v for k, v in _batch().items() if k != "img256"},
             **_cache()}
    trainer, state = _port(flatten_damsm_state(jax_state),
                           fused_similarity=fused)
    for i in range(3):
        jax_state, want = jax_trainer.train_step_cached(jax_state,
                                                        _jax(batch))
        state, got = trainer.train_step_cached(state, batch)
        _assert_metrics(got, {k: float(want[k]) for k in METRICS})
        if i in (0, 2):
            _assert_trainable(state, flatten_damsm_state(jax_state))


# ---- the feature cache

def _records(flip_every=3, n=10, seed=5):
    """n (pixels, flip) pairs; every ``flip_every``-th flipped."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8),
             i % flip_every == 1) for i in range(n)]


@pytest.mark.parametrize("cache_dtype", [np.float16, np.float32])
def test_feature_cache_matches_jax(cache_dtype):
    """10 records at batch 4 (a ragged last batch, which JAX pads)."""
    records = _records()
    jax_trainer, jax_state = _jax_state()
    want = jax_trainer.precompute_trunk_features(
        jax_state, JaxDataset(records=[JaxRecord(f"{i}", p, flip=f)
                                       for i, (p, f) in enumerate(records)]),
        cache_dtype=cache_dtype)
    trainer, state = _port(flatten_damsm_state(jax_state))
    got = trainer.precompute_trunk_features(
        state, Dataset(records=[Record(f"{i}", p, flip=f)
                                for i, (p, f) in enumerate(records)]),
        cache_dtype=cache_dtype)
    assert got["regions"].shape == (10, 289, TINY_FEATURES)
    assert got["pooled"].shape == (10, TINY_FEATURES)
    for key in ("regions", "pooled"):
        assert got[key].dtype == cache_dtype
        # fp16: one fp16 step (2^-10 of the value) beside the fp32 values'
        # own 1e-5, which near 0 spans several fp16 steps
        np.testing.assert_allclose(
            got[key].astype(np.float32), want[key].astype(np.float32),
            rtol=2.0 ** -10 if cache_dtype == np.float16 else 0.0, atol=1e-5)


def test_fp32_cache_gives_the_plain_step():
    """With dropout 0.5: both forms draw the same masks from one seed."""
    records = _records()
    dataset = Dataset(records=[Record(f"{i}", p, flip=f, caption=["a", "b"])
                               for i, (p, f) in enumerate(records)])
    dataset.build_vocab()
    trainer = DamsmTrainer(DamsmConfig(**{**SHAPE, "dropout": 0.5}),
                           dataset.vocab.n_words, 2, device="cpu")
    cache = trainer.precompute_trunk_features(trainer.init_state(seed=2),
                                              dataset,
                                              cache_dtype=np.float32)
    host = next(dataset.iter_batches(B, 2, seed=1))
    idx = host["indices"]
    plain, cached = trainer.init_state(seed=2), trainer.init_state(seed=2)
    for _ in range(2):
        _, want = trainer.train_step(plain,
                                     Dataset.device_batch(host, "cpu"))
        _, got = trainer.train_step_cached(cached, {
            **host, "trunk_regions": cache["regions"][idx],
            "trunk_pooled": cache["pooled"][idx]})
        _assert_metrics(got, want, rtol=1e-5)
    for (name, p), (_, q) in zip(plain.trainable(), cached.trainable()):
        torch.testing.assert_close(q, p, rtol=0.0, atol=1e-5, msg=name)


def test_feature_cache_refuses_an_overflow():
    trainer = DamsmTrainer(DamsmConfig(**SHAPE), VOCAB, L, device="cpu")
    state = trainer.init_state(seed=0)
    with torch.no_grad():
        state.cnn.trunk.Conv_2.bias.fill_(7e4)        # > fp16's 65504
    dataset = Dataset(records=[Record("a", p, flip=f)
                               for p, f in _records(n=2)])
    with pytest.raises(ValueError, match="overflow"):
        trainer.precompute_trunk_features(state, dataset)
    cache = trainer.precompute_trunk_features(state, dataset,
                                              cache_dtype=np.float32)
    assert np.isfinite(cache["regions"]).all()


# ---- the superbatch step

def _super_batches(k, b=B):
    batches = [_batch(seed=100 + i, b=b) for i in range(k)]
    return batches, {key: np.concatenate([x[key] for x in batches])
                     for key in batches[0]}


def test_superbatch_matches_jax():
    k = 3
    _, superbatch = _super_batches(k)
    jax_trainer, jax_state = _jax_state(superbatch=k)
    trainer, state = _port(flatten_damsm_state(jax_state), superbatch=k)
    jax_state, want = jax_trainer.train_step_super(jax_state,
                                                   _jax(superbatch))
    state, got = trainer.train_step_super(state, superbatch)
    assert {k_: tuple(v.shape) for k_, v in got.items()} == {
        k_: (k,) for k_ in want}
    _assert_metrics(got, {k_: np.asarray(v) for k_, v in want.items()})
    _assert_trainable(state, flatten_damsm_state(jax_state))


@pytest.mark.parametrize("k", [2, 3])
def test_superbatch_equals_plain_steps_with_dropout(k):
    cfg = DamsmConfig(**{**SHAPE, "dropout": 0.5, "superbatch": k})
    trainer = DamsmTrainer(cfg, VOCAB, L, device="cpu")
    batches, superbatch = _super_batches(k)
    plain, sup = trainer.init_state(seed=4), trainer.init_state(seed=4)
    want = [trainer.train_step(plain, b)[1] for b in batches]
    _, got = trainer.train_step_super(sup, superbatch)
    for key in METRICS:
        np.testing.assert_allclose(got[key].numpy(),
                                   [float(m[key]) for m in want], rtol=1e-5,
                                   err_msg=key)
    assert sup.step == plain.step == k
    for (name, p), (_, q) in zip(plain.trainable(), sup.trainable()):
        torch.testing.assert_close(q, p, rtol=0.0, atol=1e-5, msg=name)
    assert torch.equal(sup.generator.get_state(), plain.generator.get_state())


def test_superbatch_refuses_other_row_counts():
    trainer = DamsmTrainer(DamsmConfig(**{**SHAPE, "superbatch": 2}), VOCAB,
                           L, device="cpu")
    with pytest.raises(ValueError, match="expects 2x4 rows, got 4"):
        trainer.train_step_super(trainer.init_state(0), _batch())


# ---- the constructor's refusals

@pytest.mark.parametrize("flags", [
    dict(cache_region_features=True, trunk_train_mode_bn=True),
    dict(superbatch=2, trunk_train_mode_bn=True)],
    ids=["cache_and_bn", "superbatch_and_bn"])
def test_constructor_refuses_what_jax_refuses(flags):
    with pytest.raises(ValueError) as want:
        JaxDamsmTrainer(JaxDamsmConfig(**SHAPE, **flags), VOCAB, L,
                        image_res=RES)
    with pytest.raises(ValueError) as got:
        DamsmTrainer(DamsmConfig(**SHAPE, **flags), VOCAB, L, device="cpu")
    assert str(got.value) == str(want.value)


# ---- the Inception trunk: pretrained weights, train-mode BN

@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """The oracle's trunk (random weights and statistics) as a
    torchvision-keyed .pth, AuxLogits / fc / num_batches_tracked included,
    and JAX's state from it: tools/convert_torch_weights.py's msgpack,
    load_converted, init_state(pretrained_cnn=). Returns (.pth path, the
    file's state_dict, the JAX trainer, the flat JAX state)."""
    d = tmp_path_factory.mktemp("inception")
    sd = dict(randomize_(TInceptionTrunk(), seed=3).state_dict())
    assert sum(k.endswith("num_batches_tracked") for k in sd) == 94
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    pth, msgpack = str(d / "inception_v3.pth"), str(d / "inception.msgpack")
    torch.save(sd, pth)
    convert_torch_weights.main(["convert", "inception", pth, msgpack])
    trainer = JaxDamsmTrainer(JaxDamsmConfig(**INCEPTION), VOCAB, L,
                              image_res=RES)
    state = jax.jit(lambda p: trainer.init_state(0, pretrained_cnn=p))(
        load_converted(msgpack))
    return pth, sd, trainer, flatten_damsm_state(state)


def _trunk_stats(module):
    return {k: v.clone() for k, v in module.trunk.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_train_mode_bn_matches_jax(inception):
    _, _, _, flat = inception
    jax_trainer = JaxDamsmTrainer(
        JaxDamsmConfig(**INCEPTION, trunk_train_mode_bn=True), VOCAB, L,
        image_res=RES)
    batch = _batch(b=2)
    jax_state, want = jax_trainer.train_step(
        _jax_state_from_flat(jax_trainer, flat), _jax(batch))
    trainer, state = _port(flat, INCEPTION, trunk_train_mode_bn=True)
    before = _trunk_stats(state.cnn)
    state, got = trainer.train_step(state, batch)
    _assert_metrics(got, {k: float(want[k]) for k in METRICS})
    want_stats = convert_damsm_flat(flatten_damsm_state(jax_state))["cnn"]
    after = _trunk_stats(state.cnn)
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), want_stats[f"trunk.{k}"],
                                   rtol=ATOL, atol=ATOL, err_msg=k)
        assert not torch.equal(v, before[k]), f"{k} did not move"
    assert not state.cnn.trunk.training


def _jax_state_from_flat(trainer, flat):
    """A fresh JAX DamsmState with the flat state's weights and statistics
    (the fixture's own may be donated by a step), its Adam state new, as
    init_state makes it."""
    from attngan_tpu.train.damsm_trainer import DamsmState as JaxDamsmState

    tree = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    rnn = jax.tree.map(jnp.asarray, tree["rnn_params"])
    heads = jax.tree.map(jnp.asarray, tree["cnn_head_params"])
    return JaxDamsmState(
        rnn_params=rnn, cnn_head_params=heads,
        cnn_trunk_params=jax.tree.map(jnp.asarray, tree["cnn_trunk_params"]),
        cnn_stats=jax.tree.map(jnp.asarray, tree["cnn_stats"]),
        opt_state=trainer.optimizer.init({"rnn": rnn, "cnn_heads": heads}),
        step=jnp.asarray(tree["step"]), key=jax.random.key(1))


def test_default_step_leaves_the_trunk_statistics(inception):
    _, _, _, flat = inception
    trainer, state = _port(flat, INCEPTION)
    before = _trunk_stats(state.cnn)
    trainer.train_step(state, _batch(b=2))
    after = _trunk_stats(state.cnn)
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_train_mode_bn_drops_the_stale_folded_trunk(inception):
    """An eval step folds the trunk; a train-mode BN step on the same state
    moves the statistics and drops the fold, so that the next eval forward
    (a cache, a later eval step) refolds from the moved statistics."""
    _, _, _, flat = inception
    eval_trainer, state = _port(flat, INCEPTION)
    bn_trainer = DamsmTrainer(
        DamsmConfig(**INCEPTION, trunk_train_mode_bn=True), VOCAB, L,
        device="cpu")
    batch = _batch(b=2)
    img = torch.from_numpy(batch["img256"])
    eval_trainer.train_step(state, batch)
    stale = state.frozen_trunk
    assert stale is not None
    bn_trainer.train_step(state, batch)
    assert state.frozen_trunk is None
    regions, pooled = eval_trainer._eval_trunk_forward(state, img)
    with torch.no_grad():
        want_r, want_p = eval_trainer._flat_regions(
            *state.cnn.trunk(img.permute(0, 3, 1, 2)))
        old_r, _ = eval_trainer._flat_regions(*stale(img.permute(0, 3, 1, 2)))
    torch.testing.assert_close(regions, want_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pooled, want_p, rtol=1e-4, atol=1e-5)
    assert float((old_r - want_r).abs().max()) > 1e-3


def test_pretrained_cnn_matches_jax(inception, tmp_path):
    """The port's flag (one fp32 step on the CPU) loads the file's trunk
    bit for bit, the same trunk JAX's converter gives; with JAX's heads,
    encode_image agrees at batch 1."""
    pth, sd, jax_trainer, flat = inception
    _, state, _ = pretrain.main([
        "--synthetic", "4", "--batch-size", "4", "--epochs", "1",
        "--image-encoder", "inception_v3", "--compute-dtype", "float32",
        "--emb-dim", "16", "--device", "cpu", "--pretrained-cnn", pth,
        "--captions-path", str(tmp_path / "caps.json"),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--image-dir", str(tmp_path / "img")])
    assert state.step == 1
    trunk = state.cnn.trunk.state_dict()
    assert set(trunk) == {k for k in sd if not k.startswith(("AuxLogits",
                                                            "fc"))
                          and not k.endswith("num_batches_tracked")}
    converted = convert_damsm_flat(flat)["cnn"]
    for k, v in trunk.items():
        assert torch.equal(v, sd[k]), k
        assert torch.equal(v, converted[f"trunk.{k}"]), k
    state.cnn.load_state_dict(converted, strict=True)     # JAX's heads
    x = (np.random.default_rng(9).standard_normal((1, 256, 256, 3)) * 0.5
         ).astype(np.float32)
    want = jax.jit(jax_trainer.encode_image)(
        _jax_state_from_flat(jax_trainer, flat), jnp.asarray(x))
    got = DamsmTrainer(DamsmConfig(**INCEPTION), VOCAB, L,
                       device="cpu").encode_image(state, x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ATOL,
                                   atol=ATOL)


@pytest.mark.parametrize("fault", ["missing", "misshapen", "unexpected"])
def test_pretrained_trunk_loads_strictly(inception, tmp_path, fault):
    pth, sd, _, _ = inception
    sd = dict(sd)
    if fault == "missing":
        del sd["Mixed_6e.branch7x7_2.bn.running_var"]
        match = "Missing key"
    elif fault == "misshapen":
        sd["Conv2d_1a_3x3.conv.weight"] = torch.zeros(32, 3, 5, 5)
        match = "size mismatch"
    else:
        sd["Mixed_5b.extra.weight"] = torch.zeros(3)
        match = "Unexpected key"
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    trainer = DamsmTrainer(DamsmConfig(**INCEPTION), VOCAB, L, device="cpu")
    with pytest.raises(RuntimeError, match=match):
        trainer.init_state(0, pretrained_cnn=load_pretrained_trunk(path))


def test_pretrained_trunk_drops_heads_and_counters():
    sd = {"Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(5),
          "Conv2d_1a_3x3.bn.running_mean": torch.zeros(3),
          "AuxLogits.fc.weight": torch.zeros(1), "fc.bias": torch.zeros(1)}
    assert list(torchvision_trunk_state_dict(sd)) == [
        "Conv2d_1a_3x3.bn.running_mean"]


def test_pretrained_cnn_is_refused_for_the_tiny_encoder(tmp_path):
    trainer = DamsmTrainer(DamsmConfig(**SHAPE), VOCAB, L, device="cpu")
    with pytest.raises(ValueError, match="Inception-v3 trunk"):
        trainer.init_state(0, pretrained_cnn={})


# ---- the attention maps

def _maps_datasets():
    """10 records at batch 4 (the ragged last 2 dropped), captions of 1-5
    words over 9 tokens."""
    rng = np.random.default_rng(8)
    recs = _records()
    caps = [[f"w{t}" for t in rng.integers(0, 9, rng.integers(1, L + 1))]
            for _ in recs]
    port = Dataset(records=[Record(f"{i}", p, flip=f, caption=c)
                            for i, ((p, f), c) in enumerate(zip(recs, caps))])
    jds = JaxDataset(records=[JaxRecord(f"{i}", p, flip=f, caption=c)
                              for i, ((p, f), c) in enumerate(zip(recs,
                                                                  caps))])
    for d in (port, jds):
        d.build_vocab()
    return port, jds


@pytest.mark.parametrize("limit", [0, 5])
def test_attention_maps_match_jax(limit):
    port_ds, jax_ds = _maps_datasets()
    vocab, seq = port_ds.vocab.n_words, port_ds.max_seqlen
    jax_trainer = JaxDamsmTrainer(JaxDamsmConfig(**SHAPE), vocab, seq,
                                  image_res=RES)
    jax_state = jax_trainer.init_state(seed=0)
    want = list(jax_trainer.iter_attention_maps(jax_state, jax_ds,
                                                limit=limit))
    trainer = DamsmTrainer(DamsmConfig(**SHAPE), vocab, seq, device="cpu")
    state = trainer.init_state(seed=1)
    load_damsm_flat(flatten_damsm_state(jax_state), state)
    threads = threading.active_count()
    got = list(trainer.iter_attention_maps(state, port_ds, limit=limit))
    assert len(got) == len(want) == (limit or 8)
    for a, b in zip(got, want):
        assert a.shape == (seq, 17, 17) and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    deadline = time.monotonic() + 5
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == threads      # the prefetch ended


def test_populate_attention_maps_writes_pngs(tmp_path):
    dataset, _ = _maps_datasets()
    trainer = DamsmTrainer(DamsmConfig(**SHAPE), dataset.vocab.n_words,
                           dataset.max_seqlen, device="cpu")
    state = trainer.init_state(seed=0)
    maps = list(trainer.iter_attention_maps(state, dataset, limit=5))
    lengths = [min(len(r.caption), dataset.max_seqlen)
               for r in dataset.records[:5]]
    for m, n in zip(maps, lengths):
        np.testing.assert_allclose(m[:n].sum(axis=(1, 2)), 1.0, atol=1e-5)
    assert trainer.populate_attention_maps(state, dataset, str(tmp_path),
                                           limit=5) == 5
    assert sorted(os.listdir(tmp_path)) == [f"attn_{i:06d}.png"
                                            for i in range(5)]
    for i, m in enumerate(maps):
        png = read_png(str(tmp_path / f"attn_{i:06d}.png"))
        norm = m / (m.max(axis=(1, 2), keepdims=True) + 1e-8)
        strip = norm.transpose(1, 0, 2).reshape(17, -1)
        assert png.shape == (17, 17 * dataset.max_seqlen, 3)
        assert np.abs(png[..., 0] / 255.0 - strip).max() <= 1 / 255 + 1e-6


# ---- the loops

def _loop_histories(tmp_path, **flags):
    """The same 8 synthetic 64^2 images, state and seed through JAX's loop
    and the port's (1 epoch): (JAX's history, the port's, the port's
    state)."""
    from attngan_tpu.data.synthetic import make_synthetic_dataset as jax_syn

    from attngan_torch.data.synthetic import make_synthetic_dataset

    cfg = {**SHAPE, "emb_dim": 16, "text_emb_dim": 8, "epochs": 1, **flags}
    jds, pds = jax_syn(8, res=RES), make_synthetic_dataset(8, res=RES)
    for d in (jds, pds):
        d.build_vocab()
    jax_trainer = JaxDamsmTrainer(JaxDamsmConfig(**cfg), jds.vocab.n_words,
                                  jds.max_seqlen, image_res=RES)
    jax_state = jax_trainer.init_state(seed=0)
    flat = flatten_damsm_state(jax_state)
    kw = dict(seed=0, image_dir=str(tmp_path / "img"), log_every=1000)
    _, _, want = jax_run_damsm(
        JaxDamsmConfig(**cfg), JaxRunConfig(
            checkpoint_dir=str(tmp_path / "jax"), **kw), jds,
        state=jax_state)
    trainer = DamsmTrainer(DamsmConfig(**cfg), pds.vocab.n_words,
                           pds.max_seqlen, device="cpu")
    state = trainer.init_state(seed=1)
    load_damsm_flat(flat, state)
    _, state, got = loops.run_damsm_training(
        DamsmConfig(**cfg), RunConfig(checkpoint_dir=str(tmp_path / "port"),
                                      **kw), pds, state=state,
        trainer=trainer)
    return want, got, state


@pytest.mark.parametrize("flags,steps", [
    (dict(cache_region_features=True), 2),
    (dict(batch_size=2, superbatch=2), 4)], ids=["cached", "superbatch"])
def test_loops_match_jax(tmp_path, capsys, flags, steps):
    want, got, state = _loop_histories(tmp_path, **flags)
    assert len(got) == len(want) == state.step == steps
    np.testing.assert_allclose(got, want, rtol=ATOL)
    if "cache_region_features" in flags:
        assert "precomputing frozen-trunk region features for 8 images" in \
            capsys.readouterr().out


def test_cached_loop_gathers_no_pixels(monkeypatch):
    """With a cache the loop's batches carry the cached rows of their
    records and read no pixels; without one they carry the pyramid."""
    from attngan_torch.data.synthetic import make_synthetic_dataset

    dataset = make_synthetic_dataset(8, res=RES)
    dataset.build_vocab()
    reads = []

    def batch_pixels(recs):
        reads.append(len(recs))
        return Dataset._batch_pixels(dataset, recs)

    monkeypatch.setattr(dataset, "_batch_pixels", batch_pixels)
    cache = {"regions": torch.arange(8.0).reshape(8, 1, 1).expand(8, 3, 2),
             "pooled": torch.arange(8.0).reshape(8, 1).expand(8, 5)}
    cpu = torch.device("cpu")
    cached = list(loops._epoch_batches(dataset, 4, dataset.max_seqlen, 0,
                                       cpu, cache))
    assert len(cached) == 2 and not reads
    rows = np.concatenate([b["trunk_regions"][:, 0, 0].numpy()
                           for b in cached])
    assert sorted(rows) == list(range(8))
    assert all("img256" not in b and b["trunk_pooled"].shape == (4, 5)
               for b in cached)
    plain = list(loops._epoch_batches(dataset, 4, dataset.max_seqlen, 0, cpu))
    assert reads == [4, 4]
    assert all(b["img256"].shape[0] == 4 and "trunk_regions" not in b
               for b in plain)


@pytest.mark.parametrize("n,k", [(5, 2), (1, 2), (4, 2)])
def test_group_superbatches_as_jax(capsys, n, k):
    """The leftover warning (ZERO steps where no group fills), as JAX's."""
    batches = [{"tokens": np.full((2, 3), i), "lengths": np.full(2, i)}
               for i in range(n)]
    got = list(loops._group_superbatches(iter(batches), k))
    out = capsys.readouterr().out
    want = list(jax_group(iter(batches), k))
    assert capsys.readouterr().out == out
    assert len(got) == len(want) == n // k
    for a, b in zip(got, want):
        assert all(np.array_equal(a[key], b[key]) for key in b)
    if n % k:
        assert f"dropped {n % k} leftover batch(es)" in out
        assert ("ZERO steps" in out) == (n < k)
    else:
        assert out == ""


def test_superbatch_loop_needs_k_full_batches(tmp_path):
    from attngan_torch.data.synthetic import make_synthetic_dataset

    cfg = DamsmConfig(**{**SHAPE, "superbatch": 3, "epochs": 1})
    run_cfg = RunConfig(checkpoint_dir=str(tmp_path / "c"),
                        image_dir=str(tmp_path / "i"))
    with pytest.raises(ValueError, match="superbatch=3 needs at least 3 "
                       r"full batches per epoch; this dataset yields at most"
                       r" 2 \(batch_size=4\)"):
        loops.run_damsm_training(cfg, run_cfg,
                                 make_synthetic_dataset(8, res=RES),
                                 device="cpu")


# ---- the CLI

def _cli(tmp_path, *flags):
    return pretrain.main([
        "--synthetic", "16", "--batch-size", "4", "--epochs", "1",
        "--image-encoder", "tiny", "--emb-dim", "16", "--compute-dtype",
        "float32", "--device", "cpu",
        "--captions-path", str(tmp_path / "caps.json"),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--image-dir", str(tmp_path / "img"), *flags])


@pytest.mark.parametrize("flags", [["--cache-features"],
                                   ["--superbatch", "2"],
                                   ["--trunk-train-mode-bn"]],
                         ids=["cache", "superbatch", "train_mode_bn"])
def test_cli_options_run_on_the_cpu(tmp_path, flags):
    trainer, state, history = _cli(tmp_path, *flags)
    cfg = trainer.cfg
    assert (cfg.cache_region_features, cfg.superbatch,
            cfg.trunk_train_mode_bn) == (flags[0] == "--cache-features",
                                         2 if "2" in flags else 1,
                                         flags[0] == "--trunk-train-mode-bn")
    assert state.step == len(history) == 4
    assert all(map(np.isfinite, history))
    assert os.path.isdir(tmp_path / "ckpt" / "damsm" / "step_00000004")


def test_cli_refuses_stream_with_cache_features(tmp_path):
    with pytest.raises(SystemExit, match="--stream and --cache-features are "
                       "incompatible"):
        _cli(tmp_path, "--stream", "--cache-features")


def test_cli_refuses_a_pretrained_cnn_for_the_tiny_encoder(tmp_path, inception):
    with pytest.raises(ValueError, match="Inception-v3 trunk"):
        _cli(tmp_path, "--pretrained-cnn", inception[0])


@pytest.mark.parametrize("flag", ["--trunk-int8"])
def test_cli_still_refuses_later_slices(capsys, flag):
    with pytest.raises(SystemExit):
        pretrain.parse_args([flag])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--cache-features"],
                                   ["--superbatch", "2"],
                                   ["--trunk-train-mode-bn"]],
                         ids=["cache", "superbatch", "train_mode_bn"])
def test_cli_options_need_the_gpu(tmp_path, monkeypatch, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(["--synthetic", "8", "--batch-size", "4",
                       "--image-encoder", "tiny", "--captions-path",
                       str(tmp_path / "caps.json"), *flags])
