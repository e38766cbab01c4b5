"""Host-side epoch loops for both training phases.

Port of attngan_tpu/train/loops.py. Reference: the notebook-style loops in
pretrain_damsm.py:110-138 and train.py:103-162. Same responsibilities:
degenerate-batch skipping, per-epoch checkpoints (the final epoch always),
loss plots, fixed-noise sample grids; with checkpoints of the whole state,
so that ``resume`` continues exactly where a run stopped.

A prefetch thread assembles each epoch's host batches in page-locked
memory; the main thread copies them to the device and builds the pyramid
on its own stream (data/prefetch.py says why). The steps' metrics stay on
the device until a log line or the epoch's end reads them, so that the
host does not wait for the device inside an epoch. The JAX loop's
feature-cache and superbatch branches wait for their slice.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from attngan_torch.core.config import DamsmConfig, GanConfig, RunConfig
from attngan_torch.data.dataset import Dataset, pinned_batch, word_mask
from attngan_torch.data.prefetch import prefetch
from attngan_torch.infer.sampler import denormalize
from attngan_torch.train.checkpoint import (
    latest_checkpoint,
    load_progress_sidecar,
    restore_checkpoint,
    save_checkpoint,
)
from attngan_torch.train.damsm_trainer import DamsmState, DamsmTrainer
from attngan_torch.train.gan_trainer import GanState, GanTrainer
from attngan_torch.utils.imaging import (
    plot_history,
    save_attention_maps,
    save_image_grids,
)
from attngan_torch.utils.timing import StepTimer, StepWindowProfiler


def _maybe_resume(state, directory: str, resume: bool):
    """Exact resume from the newest checkpoint (every module, optimizer
    state, the step and the generator's state) — the reference's per-epoch
    pickles could not resume optimizers at all (Adam name collision,
    SURVEY.md §3.2).

    Returns ``(state, start_epoch)``: the loop continues at epoch
    ``start_epoch + 1``, so ``cfg.epochs`` is the run's TOTAL epoch count
    and a resumed run's logs/snapshots keep the original numbering."""
    if not resume:
        return state, 0
    ckpt = latest_checkpoint(directory)
    if ckpt is None:
        print(f"--resume: no checkpoint under {directory}, starting fresh")
        return state, 0
    start_epoch = load_progress_sidecar(directory)
    print(f"resuming from {ckpt} (epoch {start_epoch} done)")
    return restore_checkpoint(ckpt, state), start_epoch


def _skip_batch(host_batch, batch_size: int) -> bool:
    """min(len) < 2 or ragged (reference train.py:112-113)."""
    return (host_batch["lengths"].min() < 2
            or host_batch["tokens"].shape[0] < batch_size)


def _epoch_batches(dataset: Dataset, batch_size: int, seq_len: int,
                   seed: int, device: torch.device):
    """One epoch's batches on ``device``, their host side prepared by the
    prefetch thread."""
    batches = (b for b in dataset.iter_batches(batch_size, seq_len, seed=seed)
               if not _skip_batch(b, batch_size))
    for host in prefetch(batches, lambda b: pinned_batch(b, device)):
        yield dataset.device_batch(host, device)


def _read_back(pending: List[Dict[str, torch.Tensor]],
               into: Dict[str, list]) -> None:
    """Append the pending steps' metrics (0-d device tensors) to ``into``'s
    lists as floats, one copy per metric, and clear ``pending``."""
    if pending:
        for key in pending[0]:
            into[key].extend(torch.stack([m[key] for m in pending]).tolist())
        pending.clear()


def run_damsm_training(
    cfg: DamsmConfig,
    run_cfg: RunConfig,
    dataset: Dataset,
    state: Optional[DamsmState] = None,
    trainer: Optional[DamsmTrainer] = None,
    resume: bool = False,
    device: str | torch.device | None = None,
):
    """DAMSM pretraining for ``cfg.epochs`` epochs (the GPU unless
    ``device`` says otherwise). Returns (trainer, state, loss history)."""
    dataset.build_vocab()
    seq_len = max(dataset.max_seqlen, 1)
    if trainer is None:
        trainer = DamsmTrainer(cfg, vocab_size=dataset.vocab.n_words,
                               seq_len=seq_len, device=device)
    start_epoch = 0
    if state is None:
        state = trainer.init_state(run_cfg.seed)
        state, start_epoch = _maybe_resume(
            state, os.path.join(run_cfg.checkpoint_dir, "damsm"), resume)

    metrics: Dict[str, list] = defaultdict(list)
    history = metrics["loss"]
    pending: List[Dict[str, torch.Tensor]] = []
    timer = StepTimer()
    profiler = StepWindowProfiler(
        os.path.join(run_cfg.checkpoint_dir, "profile_damsm"),
        enabled=run_cfg.profile)
    if start_epoch >= cfg.epochs:
        print(f"--resume: checkpoint already at epoch {start_epoch} >= "
              f"--epochs {cfg.epochs}; nothing to train")
    for epoch in range(start_epoch + 1, cfg.epochs + 1):
        for batch in _epoch_batches(dataset, cfg.batch_size, seq_len,
                                    run_cfg.seed + epoch, trainer.device):
            state, m = trainer.train_step(state, batch)
            pending.append({"loss": m["loss"]})
            timer.tick()
            profiler.tick()
            if (len(history) + len(pending)) % run_cfg.log_every == 0:
                _read_back(pending, metrics)
                print(f"epoch {epoch} step {len(history)} "
                      f"loss {history[-1]:.3f} "
                      f"({timer.steps_per_sec:.2f} steps/s)")
        _read_back(pending, metrics)
        # always snapshot the final epoch, even when epochs is not a
        # multiple of checkpoint_every_epochs — otherwise the tail of the
        # run trains and is silently discarded
        if epoch % run_cfg.checkpoint_every_epochs == 0 or epoch == cfg.epochs:
            save_checkpoint(os.path.join(run_cfg.checkpoint_dir, "damsm"),
                            state, state.step, cfg, epoch=epoch)
            if history:
                plot_history(history,
                             os.path.join(run_cfg.image_dir,
                                          f"epoch_{epoch}-damsm_loss.png"))
        print(f"===== epoch {epoch} done; mean loss "
              f"{np.mean(history[-100:]) if history else float('nan'):.3f} =====")
    profiler.close()
    return trainer, state, history


def run_gan_training(
    cfg: GanConfig,
    run_cfg: RunConfig,
    dataset: Dataset,
    state: Optional[GanState] = None,
    trainer: Optional[GanTrainer] = None,
    rnn: Optional[torch.nn.Module] = None,
    cnn: Optional[torch.nn.Module] = None,
    resume: bool = False,
    device: str | torch.device | None = None,
):
    """GAN training for ``cfg.epochs`` epochs with the DAMSM encoders
    ``rnn`` and ``cnn`` frozen (random without them), on the GPU unless
    ``device`` says otherwise. Returns (trainer, state, {metric: history})."""
    dataset.build_vocab()
    if trainer is None:
        trainer = GanTrainer(cfg, vocab_size=dataset.vocab.n_words,
                             device=device)
    start_epoch = 0
    if state is None:
        state = trainer.init_state(run_cfg.seed, rnn=rnn, cnn=cnn)
        state, start_epoch = _maybe_resume(
            state, os.path.join(run_cfg.checkpoint_dir, "gan"), resume)

    losses: Dict[str, list] = defaultdict(list)
    pending: List[Dict[str, torch.Tensor]] = []
    dev = trainer.device
    fixed_noise = torch.randn(
        (cfg.batch_size, cfg.z_dim), device=dev,
        generator=torch.Generator(dev).manual_seed(run_cfg.seed))
    last_embed = None
    timer = StepTimer()
    profiler = StepWindowProfiler(
        os.path.join(run_cfg.checkpoint_dir, "profile_gan"),
        enabled=run_cfg.profile)
    step_count = 0
    if start_epoch >= cfg.epochs:
        print(f"--resume: checkpoint already at epoch {start_epoch} >= "
              f"--epochs {cfg.epochs}; nothing to train")
    for epoch in range(start_epoch + 1, cfg.epochs + 1):
        for batch in _epoch_batches(dataset, cfg.batch_size, cfg.seq_len,
                                    run_cfg.seed + epoch, dev):
            last_embed = (batch["tokens"], batch["lengths"])
            state, metrics = trainer.train_step(state, batch)
            pending.append(metrics)
            timer.tick()
            profiler.tick()
            step_count += 1
            if step_count % run_cfg.log_every == 0:
                _read_back(pending, losses)
                head = {k: round(v[-1], 3) for k, v in losses.items()}
                print(f"epoch {epoch} step {step_count} {head} "
                      f"({timer.steps_per_sec:.2f} steps/s)")
        _read_back(pending, losses)
        # per-epoch snapshot (reference train.py:154-162); the final epoch
        # always saves, even when epochs % checkpoint_every_epochs != 0
        if epoch % run_cfg.checkpoint_every_epochs == 0 or epoch == cfg.epochs:
            save_checkpoint(os.path.join(run_cfg.checkpoint_dir, "gan"),
                            state, state.step, cfg, epoch=epoch)
            if last_embed is not None:
                _sample_grid(trainer, state, last_embed, fixed_noise,
                             epoch, run_cfg)
            for name in ("g_total", f"d_loss_{cfg.resolutions[-1]}"):
                if losses.get(name):
                    plot_history(losses[name],
                                 os.path.join(run_cfg.image_dir,
                                              f"epoch_{epoch}-{name}.png"))
        print(f"===== epoch {epoch} done =====")
    profiler.close()
    return trainer, state, dict(losses)


def _sample_grid(trainer: GanTrainer, state: GanState, last_embed,
                 fixed_noise: torch.Tensor, epoch: int,
                 run_cfg: RunConfig) -> None:
    """Fixed-noise evaluation grid + word-attention strips of the first
    sample, like reference train.py:154-158 + the attention viewers. The
    eval-mode cascade (``GanTrainer.generate``) leaves the generator in the
    mode it found it in."""
    tokens, lengths = last_embed
    word_embs, sent_embs = trainer.embed_text(state, tokens, lengths)
    mask = word_mask(lengths.to(trainer.device), trainer.cfg.seq_len)
    fakes, attns, _, _ = trainer.generate(
        state, fixed_noise, sent_embs, word_embs, mask,
        generator=torch.Generator(trainer.device).manual_seed(run_cfg.seed))
    save_image_grids([denormalize(f).float().cpu().numpy() for f in fakes],
                     epoch, run_cfg.image_dir)
    for attn in attns:                      # (B, L, h, w) per attention stage
        res = attn.shape[-1]
        save_attention_maps(
            attn[0].float().cpu().numpy(),
            os.path.join(run_cfg.image_dir, f"epoch_{epoch}-attn{res}.png"))
