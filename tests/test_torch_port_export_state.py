"""export_jax_state.py and ``python -m attngan_torch.convert``: a JAX
checkpoint into a port checkpoint directory.

A tiny JAX GanState (2 stages, gf 4) and DamsmState (tiny encoder), each
after one step of its trainer (so that every Adam moment is non-zero), and
the GanState's InferState are saved with attngan_tpu.train.checkpoint.
save_checkpoint, exported, and converted. Checks:
- the exported keys and arrays are exactly those of the in-test flatten
  helpers of record (tests/test_torch_port_{damsm,gan}_trainer.py);
- the port serves the converted InferState: ``cli.infer --checkpoint
  DIR --benchmark``, and its restore with JAX's noise and eps gives the
  JAX Sampler's images within 1e-4 (fp32; tests/test_torch_port_models.py's
  tolerance);
- the converted GanState and DamsmState, restored as ``--resume`` restores
  them, equal the states that the helpers' dicts load, bit for bit, and so
  do the states after one more port step on each;
- ``load_damsm_encoders`` (``cli.train --damsm-checkpoint``) reads the
  DamsmState's encoders.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attngan_tpu.core.config import DamsmConfig as JaxDamsmConfig
from attngan_tpu.core.config import GanConfig as JaxGanConfig
from attngan_tpu.infer.sampler import Sampler as JaxSampler
from attngan_tpu.infer.sampler import as_infer_state
from attngan_tpu.train.checkpoint import save_checkpoint as jax_save
from attngan_tpu.train.damsm_trainer import DamsmTrainer as JaxDamsmTrainer
from attngan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.cli import infer
from attngan_torch.cli.train import load_damsm_encoders
from attngan_torch.convert import load_damsm_flat, load_gan_flat
from attngan_torch.convert import main as convert_main
from attngan_torch.core.config import DamsmConfig, GanConfig
from attngan_torch.infer.sampler import Sampler
from attngan_torch.train.checkpoint import (
    diff_parts,
    latest_checkpoint,
    restore_checkpoint,
    restore_inference_state,
    state_parts,
)
from attngan_torch.train.damsm_trainer import DamsmTrainer
from attngan_torch.train.gan_trainer import GanTrainer
from test_torch_port_damsm_trainer import flatten_damsm_state
from test_torch_port_gan_trainer import flatten_gan_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, VOCAB = 2, 4, 30
GAN = dict(gf_dim=4, df_dim=4, emb_dim=16, cond_dim=4, z_dim=4, seq_len=L,
           batch_size=B, num_stages=2, image_encoder="tiny", compute_dtype="")
DAMSM = dict(emb_dim=16, batch_size=B, image_encoder="tiny",
             compute_dtype="", dropout=0.0)


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_state", os.path.join(REPO, "export_jax_state.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(keys, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, VOCAB, (B, L)).astype(np.int32),
             "lengths": np.array([4, 2], np.int32),
             "class_ids": np.array([0, 1], np.int32)}
    for key in keys:
        res = int(key[3:])
        batch[key] = np.tanh(rng.standard_normal(
            (B, res, res, 3))).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{kind: (the JAX state, its .npz, the converted port dir)}."""
    root = tmp_path_factory.mktemp("export")
    gcfg = JaxGanConfig(**GAN)
    gtrainer = JaxGanTrainer(gcfg, vocab_size=VOCAB)
    gan, _ = gtrainer.train_step(
        jax.jit(gtrainer.init_state, static_argnums=0)(0),
        {k: jnp.asarray(v) for k, v in _batch(("img64", "img128")).items()})
    dcfg = JaxDamsmConfig(**DAMSM)
    dtrainer = JaxDamsmTrainer(dcfg, vocab_size=VOCAB, seq_len=L,
                               image_res=64)
    batch = _batch(("img64",))
    batch["img256"] = batch.pop("img64")
    damsm, _ = dtrainer.train_step(
        dtrainer.init_state(seed=0),
        {k: jnp.asarray(v) for k, v in batch.items()})
    states = {"gan": (gan, gcfg), "damsm": (damsm, dcfg),
              "infer": (as_infer_state(gan), gcfg)}
    exporter = _exporter()
    out = {"trainer": gtrainer}
    for kind, (state, cfg) in states.items():
        jax_save(str(root / "jax" / kind), state, 1, cfg, epoch=1)
        npz = str(root / f"{kind}.npz")
        meta = exporter.main([str(root / "jax" / kind), "--out", npz])
        assert meta["kind"] == kind and meta["vocab_size"] == VOCAB
        port = str(root / "port" / kind)
        convert_main([npz, "--out", port])
        out[kind] = (state, npz, port)
    return out


@pytest.mark.parametrize("kind,helper", [("damsm", flatten_damsm_state),
                                         ("gan", flatten_gan_state)])
def test_export_matches_the_flatten_helpers(exported, kind, helper):
    state, npz, _ = exported[kind]
    want = helper(state)
    with np.load(npz) as f:
        got = {k: f[k] for k in f.files if k != "__meta__"}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_exported_infer_state_serves_the_jax_images(exported):
    state, npz, port = exported["infer"]
    with np.load(npz) as f:
        assert not any(k.startswith(("disc_", "opt")) for k in f.files)
    result = infer.main(["--checkpoint", port, "--device", "cpu",
                         "--benchmark", "--batch-size", "2",
                         "--compute-dtype", "float32"])
    assert result["devices"] == 1 and result["value"] > 0

    batch = _batch(())
    tokens, lengths = batch["tokens"], batch["lengths"]
    key = jax.random.key(5)
    k_noise, k_reparam = jax.random.split(key)
    noise = np.array(jax.random.normal(k_noise, (B, GAN["z_dim"])))
    eps = np.array(jax.random.normal(k_reparam, (B, GAN["cond_dim"])))
    want, _ = JaxSampler(exported["trainer"], state).generate_stages(
        jnp.asarray(tokens), jnp.asarray(lengths), key)
    cfg = GanConfig(**dict(GAN, compute_dtype="float32"))
    sampler = Sampler(restore_inference_state(latest_checkpoint(port), cfg),
                      device="cpu")
    got, _ = sampler.generate_stages(tokens, lengths,
                                     torch.from_numpy(noise),
                                     torch.from_numpy(eps))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_resumed_gan_step_equals_the_helper_step(exported):
    state, _, port = exported["gan"]
    trainer = GanTrainer(GanConfig(**GAN), VOCAB, device="cpu")
    resumed = restore_checkpoint(latest_checkpoint(port),
                                 trainer.init_state(seed=0))
    helper = trainer.init_state(seed=0)
    load_gan_flat(flatten_gan_state(state), helper)
    assert diff_parts(state_parts(resumed), state_parts(helper)) == []
    assert resumed.step == 1
    batch = _batch(("img64", "img128"), seed=4)
    draws = {"noise": torch.randn(B, GAN["z_dim"]),
             "eps": torch.randn(B, GAN["cond_dim"])}
    for s in (resumed, helper):
        trainer.train_step(s, batch, **draws)
    assert diff_parts(state_parts(resumed), state_parts(helper)) == []


def test_resumed_damsm_step_equals_the_helper_step(exported):
    state, _, port = exported["damsm"]
    trainer = DamsmTrainer(DamsmConfig(**DAMSM), VOCAB, L, device="cpu")
    resumed = restore_checkpoint(latest_checkpoint(port),
                                 trainer.init_state(seed=0))
    helper = trainer.init_state(seed=0)
    load_damsm_flat(flatten_damsm_state(state), helper)
    assert diff_parts(state_parts(resumed), state_parts(helper)) == []
    assert resumed.step == 1
    rnn, cnn = load_damsm_encoders(port, GanConfig(**GAN), VOCAB, L,
                                   device="cpu")
    assert diff_parts(rnn.state_dict(), helper.rnn.state_dict()) == []
    assert diff_parts(cnn.state_dict(), helper.cnn.state_dict()) == []
    batch = _batch(("img64",), seed=4)
    batch["img256"] = batch.pop("img64")
    for s in (resumed, helper):
        trainer.train_step(s, batch)
    assert diff_parts(state_parts(resumed), state_parts(helper)) == []


@pytest.mark.parametrize("kind", ["damsm", "gan"])
def test_converted_state_takes_its_generator_from_the_seed(exported, kind):
    """JAX's PRNG key has no counterpart: the converted step holds no
    generator, and a resume keeps the one ``init_state(seed)`` made."""
    _, _, port = exported[kind]
    ckpt = latest_checkpoint(port)
    assert "generator.pt" not in os.listdir(ckpt)
    trainer = (DamsmTrainer(DamsmConfig(**DAMSM), VOCAB, L, device="cpu")
               if kind == "damsm" else
               GanTrainer(GanConfig(**GAN), VOCAB, device="cpu"))
    resumed = restore_checkpoint(ckpt, trainer.init_state(seed=7))
    want = trainer.init_state(seed=7).generator.get_state()
    assert torch.equal(resumed.generator.get_state(), want)
    assert not torch.equal(trainer.init_state(seed=0).generator.get_state(),
                           want)


def test_convert_runs_as_a_module(exported, tmp_path):
    _, npz, _ = exported["infer"]
    out = subprocess.run(
        [sys.executable, "-m", "attngan_torch.convert", npz, "--out",
         str(tmp_path / "gan")], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    ckpt = latest_checkpoint(str(tmp_path / "gan"))
    assert sorted(os.listdir(ckpt)) == ["gen.pt", "rnn.pt"]
    assert sorted(os.listdir(tmp_path / "gan")) == [
        "config.json", "progress.json", os.path.basename(ckpt)]


def test_exporter_needs_the_config_sidecar(exported, tmp_path):
    state, _, _ = exported["infer"]
    path = jax_save(str(tmp_path / "bare"), state, 1)
    with pytest.raises(SystemExit, match="no config.json sidecar"):
        _exporter().main([path, "--out", str(tmp_path / "x.npz")])
