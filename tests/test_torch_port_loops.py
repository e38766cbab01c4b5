"""The port's training loops, checkpoints and CLIs, on the CPU at tiny dims.

- Both loops write their ``step_*`` checkpoints, the ``config.json`` and
  ``progress.json`` sidecars, the per-epoch loss plots (and the GAN's
  sample grids and attention strips) at every ``checkpoint_every_epochs``
  epoch and at a final epoch that is not one.
- Exact resume: 2 epochs straight and 1 epoch, a restore into a fresh
  state, then 1 more end bit-identical in every parameter, BN statistic,
  optimizer state, step and generator state, for both loops; a restore
  reads back exactly what was saved; a checkpoint already at --epochs
  trains nothing.
- ``_skip_batch`` decides as the JAX loop's does; the sample grid leaves
  the generator in the mode it found it in; ``restore_inference_state``
  needs only the checkpoint's text encoder and generator and serves the
  trained generator's images; ``load_damsm_encoders`` needs only a DAMSM
  checkpoint's encoders.
- The CLI chain pretrain -> train -> infer (--swap, --all-stages,
  --save-attention, --benchmark) runs in a process where Pillow,
  matplotlib and scikit-learn cannot be imported, and writes every file the
  JAX CLIs write; without --checkpoint, cli.infer serves <checkpoint
  dir>/gan's newest step, or random weights where there is none.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from attngan_tpu.train.loops import _skip_batch as jax_skip_batch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.cli import infer, pretrain, train
from attngan_torch.core.config import DamsmConfig, GanConfig, RunConfig, replace
from attngan_torch.data.synthetic import make_synthetic_dataset
from attngan_torch.infer.sampler import Sampler, denormalize
from attngan_torch.train import loops
from attngan_torch.train.checkpoint import (
    diff_parts,
    latest_checkpoint,
    load_part,
    load_progress_sidecar,
    restore_checkpoint,
    restore_inference_state,
    state_parts,
)
from attngan_torch.train.damsm_trainer import DamsmTrainer
from attngan_torch.train.gan_trainer import GanTrainer
from attngan_torch.utils.imaging import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAMSM = DamsmConfig(emb_dim=16, text_emb_dim=8, batch_size=4, epochs=2,
                    image_encoder="tiny", compute_dtype="")
GAN = GanConfig(gf_dim=4, df_dim=4, emb_dim=16, cond_dim=4, z_dim=4,
                seq_len=4, batch_size=4, epochs=2, image_encoder="tiny",
                compute_dtype="")
GAN_FILES = ("64x64", "128x128", "256x256", "attn64", "attn128", "g_total",
             "d_loss_256")


def _run_cfg(tmp_path, **kw):
    return RunConfig(seed=0, checkpoint_dir=str(tmp_path / "ckpt"),
                     image_dir=str(tmp_path / "img"), log_every=1000, **kw)


def _dataset(res=64):
    return make_synthetic_dataset(num_images=8, num_classes=2, res=res)


def _run(kind, cfg, run_cfg, **kw):
    if kind == "damsm":
        return loops.run_damsm_training(cfg, run_cfg, _dataset(), device="cpu",
                                        **kw)
    return loops.run_gan_training(cfg, run_cfg, _dataset(256), device="cpu",
                                  **kw)


def _fresh_state(kind, cfg):
    ds = _dataset()
    ds.build_vocab()
    if kind == "damsm":
        trainer = DamsmTrainer(cfg, ds.vocab.n_words, ds.max_seqlen, "cpu")
    else:
        trainer = GanTrainer(cfg, ds.vocab.n_words, device="cpu")
    return trainer.init_state(seed=9)


def test_damsm_loop_writes_checkpoints_plots_and_trace(tmp_path):
    run_cfg = _run_cfg(tmp_path, checkpoint_every_epochs=2, profile=True)
    _, state, history = _run("damsm", replace(DAMSM, epochs=3), run_cfg)
    assert len(history) == 6 and np.all(np.isfinite(history))
    assert state.step == 6
    ckpt_dir = tmp_path / "ckpt" / "damsm"
    # epoch 2 by the period, epoch 3 because it is the last
    assert sorted(os.listdir(ckpt_dir)) == [
        "config.json", "progress.json", "step_00000004", "step_00000006"]
    assert load_progress_sidecar(str(ckpt_dir)) == 3
    assert json.loads((ckpt_dir / "config.json").read_text())["emb_dim"] == 16
    assert sorted(os.listdir(tmp_path / "img")) == [
        "epoch_2-damsm_loss.png", "epoch_3-damsm_loss.png"]
    assert read_png(str(tmp_path / "img" / "epoch_3-damsm_loss.png")).ndim == 3
    # the profiler window [2, 8) closes with the loop, after step 6
    assert os.path.getsize(tmp_path / "ckpt" / "profile_damsm" / "trace.json")


def test_gan_loop_writes_checkpoints_grids_and_plots(tmp_path):
    run_cfg = _run_cfg(tmp_path, checkpoint_every_epochs=2)
    _, state, losses = _run("gan", replace(GAN, epochs=3), run_cfg)
    assert state.step == 6 and state.gen.training
    assert all(len(v) == 6 and np.all(np.isfinite(v)) for v in losses.values())
    ckpt_dir = tmp_path / "ckpt" / "gan"
    assert sorted(os.listdir(ckpt_dir)) == [
        "config.json", "progress.json", "step_00000004", "step_00000006"]
    assert sorted(os.listdir(ckpt_dir / "step_00000006")) == [
        "cnn.pt", "disc_optimizers.pt", "discs.pt", "gen.pt",
        "gen_optimizer.pt", "generator.pt", "rnn.pt", "step.pt"]
    assert sorted(os.listdir(tmp_path / "img")) == sorted(
        f"epoch_{e}-{name}.png" for e in (2, 3) for name in GAN_FILES)
    grid = read_png(str(tmp_path / "img" / "epoch_3-256x256.png"))
    assert grid.shape == (2 * 256, 2 * 256, 3)        # 4 samples, 2 x 2
    strip = read_png(str(tmp_path / "img" / "epoch_3-attn128.png"))
    assert strip.shape == (128, GAN.seq_len * 128, 3)


@pytest.mark.parametrize("kind", ["damsm", "gan"])
def test_resume_is_exact(tmp_path, kind, capsys):
    cfg = DAMSM if kind == "damsm" else GAN
    _, straight, _ = _run(kind, cfg, _run_cfg(tmp_path / "straight"))

    split = _run_cfg(tmp_path / "split")
    _, first, _ = _run(kind, replace(cfg, epochs=1), split)
    saved = latest_checkpoint(os.path.join(split.checkpoint_dir, kind))
    # a restore into a fresh state reads back what was saved, bit for bit
    state = _fresh_state(kind, cfg)
    state.frozen_trunk = torch.nn.Identity()       # a stale cache goes
    restore_checkpoint(saved, state)
    assert state.frozen_trunk is None
    assert not diff_parts(state_parts(state), state_parts(first))
    assert not diff_parts(state_parts(state), {
        name: load_part(saved, name) for name in state_parts(state)})

    _, resumed, _ = _run(kind, cfg, split, resume=True)
    assert "resuming from" in capsys.readouterr().out
    assert resumed.step == straight.step == 2 * first.step
    assert not diff_parts(state_parts(resumed), state_parts(straight))
    # the generator's stream moved on, so the comparison above has teeth
    assert diff_parts(state_parts(resumed)["generator"],
                      state_parts(first)["generator"])


@pytest.mark.parametrize("kind", ["damsm", "gan"])
def test_nothing_to_train_at_the_total(tmp_path, kind, capsys):
    cfg = replace(DAMSM if kind == "damsm" else GAN, epochs=1)
    run_cfg = _run_cfg(tmp_path)
    _, state, _ = _run(kind, cfg, run_cfg)
    _, again, history = _run(kind, cfg, run_cfg, resume=True)
    assert "nothing to train" in capsys.readouterr().out
    assert again.step == state.step and not history


@pytest.mark.parametrize("lengths,batch_size", [
    ([2, 3, 4, 2], 4), ([2, 1, 4, 2], 4), ([2, 3, 4], 4), ([0, 2, 2, 2], 4),
    ([5, 5], 2)])
def test_skip_batch_matches_jax(lengths, batch_size):
    batch = {"lengths": np.asarray(lengths, np.int32),
             "tokens": np.zeros((len(lengths), 5), np.int32)}
    assert loops._skip_batch(batch, batch_size) == bool(
        jax_skip_batch(batch, batch_size))


@pytest.mark.parametrize("training", [True, False])
def test_sample_grid_leaves_the_generator_mode(tmp_path, training):
    cfg = replace(GAN, num_stages=2)
    trainer = GanTrainer(cfg, vocab_size=7, device="cpu")
    state = trainer.init_state(seed=0)
    state.gen.train(training)
    tokens = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0], [1, 1, 1, 1],
                           [6, 2, 0, 0]])
    lengths = torch.tensor([2, 3, 4, 2])
    noise = torch.randn(4, cfg.z_dim)
    loops._sample_grid(trainer, state, (tokens, lengths), noise, 7,
                       _run_cfg(tmp_path))
    assert all(m.training == training for m in state.gen.modules())
    assert sorted(os.listdir(tmp_path / "img")) == [
        "epoch_7-128x128.png", "epoch_7-64x64.png", "epoch_7-attn64.png"]


def test_restore_inference_state_serves_the_trained_generator(tmp_path):
    trainer, state, _ = _run("gan", replace(GAN, epochs=1), _run_cfg(tmp_path))
    ckpt = latest_checkpoint(str(tmp_path / "ckpt" / "gan"))
    only = tmp_path / "only" / os.path.basename(ckpt)
    only.mkdir(parents=True)
    for name in ("rnn.pt", "gen.pt"):          # nothing else is read
        shutil.copy(os.path.join(ckpt, name), only / name)
    infer_state = restore_inference_state(str(only), GAN)
    assert infer_state.vocab_size == trainer.vocab_size

    tokens = torch.tensor([[1, 2, 0, 0], [3, 4, 1, 2]])     # 5 words
    lengths = torch.tensor([2, 4])
    gen = torch.Generator().manual_seed(3)
    noise = torch.randn(2, GAN.z_dim, generator=gen)
    eps = torch.randn(2, GAN.cond_dim, generator=gen)
    stages, attns = Sampler(infer_state, device="cpu").generate_stages(
        tokens, lengths, noise=noise, eps=eps)
    words, sent = trainer.embed_text(state, tokens, lengths)
    mask = (torch.arange(GAN.seq_len)[None] < lengths[:, None]).int()
    fakes, want_attns, _, _ = trainer.generate(state, noise, sent, words,
                                               mask, eps=eps)
    for got, want in zip(stages + attns,
                         [denormalize(f) for f in fakes] + want_attns):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_load_damsm_encoders_reads_only_the_encoders(tmp_path):
    # the CLI's DAMSM trainer has the default word-embedding width
    cfg = replace(DAMSM, epochs=1, text_emb_dim=DamsmConfig().text_emb_dim)
    _, state, _ = _run("damsm", cfg, _run_cfg(tmp_path))
    ckpt = latest_checkpoint(str(tmp_path / "ckpt" / "damsm"))
    only = tmp_path / "only" / os.path.basename(ckpt)
    only.mkdir(parents=True)
    for name in ("rnn.pt", "cnn.pt"):          # nothing else is read
        shutil.copy(os.path.join(ckpt, name), only / name)
    ds = _dataset()
    ds.build_vocab()
    rnn, cnn = train.load_damsm_encoders(str(tmp_path / "only"), GAN,
                                         ds.vocab.n_words, ds.max_seqlen,
                                         device="cpu")
    assert not diff_parts(rnn.state_dict(), state.rnn.state_dict())
    assert not diff_parts(cnn.state_dict(), state.cnn.state_dict())


CHAIN = textwrap.dedent("""
    import json, os, sys
    sys.modules["PIL"] = sys.modules["matplotlib"] = sys.modules["sklearn"] = None
    for name in ("PIL", "matplotlib", "sklearn"):
        try:
            __import__(name)
        except ImportError:
            continue
        raise SystemExit(name + " could be imported")
    from attngan_torch.cli import infer, pretrain, train

    d = sys.argv[1]
    common = ["--checkpoint-dir", d + "/ckpt", "--image-dir", d + "/img",
              "--captions-path", d + "/caps.json", "--device", "cpu",
              "--image-encoder", "tiny", "--emb-dim", "16",
              "--compute-dtype", "float32", "--batch-size", "4",
              "--epochs", "1"]
    pretrain.main(["--synthetic", "8", *common])
    train.main(["--synthetic", "8", "--gf-dim", "4", "--df-dim", "4",
                "--seq-len", "4", "--damsm-checkpoint", d + "/ckpt/damsm",
                *common])
    serve = ["--checkpoint", d + "/ckpt/gan", "--captions-path",
             d + "/caps.json", "--device", "cpu"]
    infer.main([*serve, "--image-names", "00000", "00001", "--swap", "1",
                "--all-stages", "--save-attention", "--out", d + "/out"])
    infer.main([*serve, "--benchmark", "--batch-size", "2"])
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "attngan_tpu"))
    if bad:
        raise SystemExit("imported " + ", ".join(bad))
""")


def test_cli_chain_needs_no_pil_matplotlib_or_sklearn(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHAIN, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bench["metric"] == "gen_images_per_sec" and bench["value"] > 0
    for phase, step in (("damsm", "step_00000002"), ("gan", "step_00000002")):
        assert sorted(os.listdir(tmp_path / "ckpt" / phase)) == [
            "config.json", "progress.json", step]
    assert sorted(os.listdir(tmp_path / "img")) == sorted(
        ["epoch_1-damsm_loss.png"]
        + [f"epoch_1-{name}.png" for name in GAN_FILES])
    shapes = {"64px": (64, 64, 3), "128px": (128, 128, 3),
              "256px": (256, 256, 3), "attn64": (64, 4 * 64, 3),
              "attn128": (128, 4 * 128, 3)}
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{n}_{s}.png" for n in ("00000", "00001") for s in shapes)
    for name in ("00000", "00001"):
        for suffix, shape in shapes.items():
            assert read_png(str(tmp_path / "out" /
                                f"{name}_{suffix}.png")).shape == shape


@pytest.fixture(scope="module")
def gan_checkpoint(tmp_path_factory):
    """(the GAN checkpoint dir of a 1-epoch cli.train run, its captions)."""
    tmp_path = tmp_path_factory.mktemp("gan_checkpoint")
    run_cfg = _run_cfg(tmp_path)
    ds = _dataset(256)
    loops.run_gan_training(replace(GAN, epochs=1), run_cfg, ds, device="cpu")
    caps = tmp_path / "caps.json"
    ds.save_captions_and_class_ids(str(caps))
    return os.path.join(run_cfg.checkpoint_dir, "gan"), caps


def _infer_args(gan_checkpoint, tmp_path):
    ckpt, caps = gan_checkpoint
    return ["--checkpoint", ckpt, "--captions-path", str(caps),
            "--device", "cpu", "--image-names", "00001",
            "--out", str(tmp_path / "out")]


def test_infer_refuses_a_contradicting_shape_flag(gan_checkpoint, tmp_path,
                                                  capsys):
    ckpt, caps = gan_checkpoint
    args = _infer_args(gan_checkpoint, tmp_path)
    with pytest.raises(SystemExit, match="--gf-dim 8 contradicts .*gf_dim=4"):
        infer.main([*args, "--gf-dim", "8"])
    # a step_* dir serves too, and a flag that agrees is accepted
    paths = infer.main([*args, "--gf-dim", "4", "--checkpoint",
                        latest_checkpoint(ckpt)])
    assert read_png(paths[0]).shape == (256, 256, 3)
    with pytest.raises(SystemExit, match="step_"):
        infer.main([*args, "--checkpoint", str(tmp_path)])
    other = tmp_path / "other.json"                  # one word more
    other.write_text(json.dumps({**json.loads(caps.read_text()),
                                 "x/00001.jpg": [["k2c0", "k16c9"], 0]}))
    with pytest.raises(SystemExit, match="vocabulary of 6 words"):
        infer.main([*args, "--captions-path", str(other)])


@pytest.mark.parametrize("flags,refusal", [
    (["--df-dim", "4", "--image-encoder", "tiny", "--fused-attention"], None),
    (["--df-dim", "8"], "--df-dim 8 contradicts .*df_dim=4"),
    (["--image-encoder", "inception_v3"],
     "--image-encoder inception_v3 contradicts .*image_encoder=tiny"),
    (["--fused-attention", "--export", "x.zip"], "drop --fused-attention"),
], ids=["agree", "df_dim", "image_encoder", "fused_attention_export"])
def test_infer_takes_the_jax_model_flags(gan_checkpoint, tmp_path, capsys,
                                         flags, refusal):
    """JAX's --df-dim, --image-encoder and --fused-attention parse; the
    first two must agree with the checkpoint's config.json, and
    --fused-attention is refused with --export, as JAX refuses them."""
    args = _infer_args(gan_checkpoint, tmp_path)
    if refusal is not None:
        with pytest.raises(SystemExit, match=refusal):
            infer.main([*args, *flags])
        assert not (tmp_path / "out").exists()
        return
    paths = infer.main([*args, *flags])
    assert read_png(paths[0]).shape == (256, 256, 3)


@pytest.mark.parametrize("spelling,fused", [
    ("pallas", True), ("packed", True), ("packed64", True), ("off", False)])
def test_infer_maps_jax_upsample_routes_to_the_bool(spelling, fused):
    """JAX's --fused-upsample routes all parse; on Hopper each but 'off'
    is the one K2 route, GanConfig.fused_upsample True."""
    cfg, _ = infer._config(infer.parse_args(["--fused-upsample", spelling]))
    assert cfg.fused_upsample is fused


@pytest.mark.parametrize("present", [True, False],
                         ids=["restores", "random_weights"])
def test_infer_defaults_to_the_gan_checkpoint_dir(tmp_path, monkeypatch,
                                                  capsys, present):
    """Without --checkpoint, cli.infer serves the newest step of
    <checkpoint dir>/gan, where cli.train writes, and random weights (with
    a warning) only where there is none, as the JAX CLI does."""
    from attngan_torch.core.config import Config
    from attngan_torch.train.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Config, "CHECKPOINT_DIR", "checkpoints")
    ds = _dataset()
    ds.build_vocab()
    ds.save_captions_and_class_ids("caps.json")
    if present:
        state = GanTrainer(GAN, ds.vocab.n_words, device="cpu").init_state(3)
        save_checkpoint("checkpoints/gan", state, 5, config=GAN)
    args = ["--captions-path", "caps.json", "--device", "cpu",
            "--image-names", "00001", "--gf-dim", "4", "--emb-dim", "16",
            "--seq-len", "4"]
    got = read_png(infer.main([*args, "--out", "default"])[0])
    out = capsys.readouterr().out
    if present:
        ckpt = os.path.join(str(tmp_path), "checkpoints", "gan",
                            "step_00000005")
        assert f"restored {ckpt}" in out and "WARNING" not in out
        want = read_png(infer.main([*args, "--out", "explicit",
                                    "--checkpoint", "checkpoints/gan"])[0])
        np.testing.assert_array_equal(got, want)
    else:
        assert ("WARNING: no checkpoint found in checkpoints/gan; using "
                "random weights") in out and "restored" not in out
        assert got.shape == (256, 256, 3)


def test_the_loops_default_to_the_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(["--synthetic", "4", "--batch-size", "4",
                       "--image-encoder", "tiny", "--captions-path",
                       str(tmp_path / "caps.json")])
