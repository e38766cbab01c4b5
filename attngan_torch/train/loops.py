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
host does not wait for the device inside an epoch. With the feature cache
the thread gathers each batch's cached trunk rows instead of its pixels;
with a superbatch it concatenates K batches after the degenerate-batch
skip, and the loop unrolls the K steps' metrics into its history.

Data parallel (``RunConfig.mesh_shape`` under a ``torchrun`` launch,
parallel/mesh.py): every rank walks the same global batch order (the same
seed), decides the skips on the whole batch, and pins and copies only its
own rows. Rank 0 writes the checkpoints, grids and plots and prints; the
other ranks wait for each save at a barrier. A resume reads the same files
on every rank. A rank outside the mesh returns at once.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from attngan_torch.core.config import DamsmConfig, GanConfig, RunConfig
from attngan_torch.core.runtime import resolve_device
from attngan_torch.data.dataset import Dataset, pinned_batch, word_mask
from attngan_torch.data.prefetch import prefetch
from attngan_torch.infer.sampler import denormalize
from attngan_torch.parallel.mesh import Mesh, make_mesh
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


def _printer(mesh: Mesh):
    """print on rank 0, nothing on the other ranks."""
    return print if mesh.is_main else (lambda *args, **kwargs: None)


def _maybe_resume(state, directory: str, resume: bool, say=print):
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
        say(f"--resume: no checkpoint under {directory}, starting fresh")
        return state, 0
    start_epoch = load_progress_sidecar(directory)
    say(f"resuming from {ckpt} (epoch {start_epoch} done)")
    return restore_checkpoint(ckpt, state), start_epoch


def _skip_batch(host_batch, batch_size: int) -> bool:
    """min(len) < 2 or ragged (reference train.py:112-113)."""
    return (host_batch["lengths"].min() < 2
            or host_batch["tokens"].shape[0] < batch_size)


def _group_superbatches(batches, k: int):
    """Concatenate K consecutive host batches into one K*B superbatch
    (cfg.superbatch; a leftover group of < K batches at epoch end is
    dropped, like the reference drops ragged batches). Grouping happens
    AFTER the degenerate-batch skip, so the K inner steps are exactly the
    steps the plain loop would have taken. Warns when batches are dropped
    — and an epoch with fewer than K valid batches would otherwise train
    ZERO steps silently."""
    group, yielded = [], 0
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield {key: np.concatenate([g[key] for g in group], axis=0)
                   for key in group[0]}
            group = []
            yielded += 1
    if group:
        print(f"superbatch={k}: dropped {len(group)} leftover batch(es) "
              f"this epoch ({yielded} superbatch steps ran)"
              + ("" if yielded else
                 " — the epoch trained ZERO steps; lower --superbatch or "
                 "add data"))


def _epoch_batches(dataset: Dataset, batch_size: int, seq_len: int,
                   seed: int, device: torch.device,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   superbatch: int = 1, mesh: Optional[Mesh] = None):
    """One epoch's batches on ``device``, their host side prepared by the
    prefetch thread: K of them concatenated where ``superbatch`` = K > 1,
    and the rows of ``cache`` (host tensors of cached trunk features) in
    place of the pixels, which are then not gathered, where it is given;
    this rank's rows of each batch on a mesh of ranks."""
    rows = mesh.rows(batch_size) if mesh is not None and mesh.size > 1 else None
    batches = dataset.iter_batches(
        batch_size, seq_len, seed=seed, with_pixels=cache is None, rows=rows,
        keep=lambda b: not _skip_batch(b, batch_size))
    if superbatch > 1:
        batches = _group_superbatches(batches, superbatch)
    for host in prefetch(batches, lambda b: pinned_batch(b, device, cache)):
        yield dataset.device_batch(host, device)


def _read_back(pending: List[Dict[str, torch.Tensor]],
               into: Dict[str, list]) -> None:
    """Append the pending steps' metrics (device tensors: 0-d for a step,
    (K,) for a superbatch's K steps) to ``into``'s lists as floats, one
    copy per metric, and clear ``pending``."""
    if pending:
        for key in pending[0]:
            into[key].extend(torch.cat([m[key].reshape(-1)
                                        for m in pending]).tolist())
        pending.clear()


def run_damsm_training(
    cfg: DamsmConfig,
    run_cfg: RunConfig,
    dataset: Dataset,
    state: Optional[DamsmState] = None,
    trainer: Optional[DamsmTrainer] = None,
    resume: bool = False,
    device: str | torch.device | None = None,
    pretrained_cnn: Optional[Dict[str, torch.Tensor]] = None,
):
    """DAMSM pretraining for ``cfg.epochs`` epochs (the GPU unless
    ``device`` says otherwise), from a pretrained trunk state_dict where
    ``pretrained_cnn`` is given. Returns (trainer, state, loss history);
    (None, None, []) on a rank outside the mesh."""
    dataset.build_vocab()
    seq_len = max(dataset.max_seqlen, 1)
    mesh = make_mesh(cfg.batch_size, run_cfg.mesh_shape,
                     trainer.device if trainer else resolve_device(device))
    if mesh is None:
        return None, None, []
    say = _printer(mesh)
    if trainer is None:
        trainer = DamsmTrainer(cfg, vocab_size=dataset.vocab.n_words,
                               seq_len=seq_len, device=device, mesh=mesh)
    start_epoch = 0
    if state is None:
        state = trainer.init_state(run_cfg.seed, pretrained_cnn=pretrained_cnn)
        state, start_epoch = _maybe_resume(
            state, os.path.join(run_cfg.checkpoint_dir, "damsm"), resume, say)
    cache = None
    if cfg.cache_region_features:
        say("precomputing frozen-trunk region features for "
              f"{len(dataset.records)} images ...")
        cache = {k: torch.from_numpy(v) for k, v in
                 trainer.precompute_trunk_features(state, dataset).items()}

    metrics: Dict[str, list] = defaultdict(list)
    history = metrics["loss"]
    pending: List[Dict[str, torch.Tensor]] = []
    steps = last_logged = 0
    timer = StepTimer()
    profiler = StepWindowProfiler(
        os.path.join(run_cfg.checkpoint_dir, "profile_damsm"),
        enabled=run_cfg.profile)
    superbatch = cfg.superbatch if cache is None else 1
    if superbatch > 1:
        per_epoch = len(dataset.records) // cfg.batch_size
        if per_epoch < superbatch:
            raise ValueError(
                f"superbatch={superbatch} needs at least {superbatch} full "
                f"batches per epoch; this dataset yields at most {per_epoch}"
                f" (batch_size={cfg.batch_size})")
    step_fn = (trainer.train_step_cached if cache is not None
               else trainer.train_step_super if superbatch > 1
               else trainer.train_step)
    if start_epoch >= cfg.epochs:
        say(f"--resume: checkpoint already at epoch {start_epoch} >= "
            f"--epochs {cfg.epochs}; nothing to train")
    for epoch in range(start_epoch + 1, cfg.epochs + 1):
        for batch in _epoch_batches(dataset, cfg.batch_size, seq_len,
                                    run_cfg.seed + epoch, trainer.device,
                                    cache, superbatch, mesh):
            state, m = step_fn(state, batch)
            pending.append({"loss": m["loss"]})
            # a superbatch call is K steps: the timer counts all K, the
            # profiler window counts calls
            steps += superbatch
            timer.tick(superbatch)
            profiler.tick()
            # once per log_every steps, also where K does not divide it
            if steps - last_logged >= run_cfg.log_every:
                last_logged = steps
                _read_back(pending, metrics)
                say(f"epoch {epoch} step {len(history)} "
                    f"loss {history[-1]:.3f} "
                    f"({timer.steps_per_sec:.2f} steps/s)")
        _read_back(pending, metrics)
        # always snapshot the final epoch, even when epochs is not a
        # multiple of checkpoint_every_epochs — otherwise the tail of the
        # run trains and is silently discarded
        if epoch % run_cfg.checkpoint_every_epochs == 0 or epoch == cfg.epochs:
            save_checkpoint(os.path.join(run_cfg.checkpoint_dir, "damsm"),
                            state, state.step, cfg, epoch=epoch, mesh=mesh)
            if history and mesh.is_main:
                plot_history(history,
                             os.path.join(run_cfg.image_dir,
                                          f"epoch_{epoch}-damsm_loss.png"))
        say(f"===== epoch {epoch} done; mean loss "
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
    ``device`` says otherwise. Returns (trainer, state, {metric: history});
    (None, None, {}) on a rank outside the mesh."""
    dataset.build_vocab()
    mesh = make_mesh(cfg.batch_size, run_cfg.mesh_shape,
                     trainer.device if trainer else resolve_device(device))
    if mesh is None:
        return None, None, {}
    say = _printer(mesh)
    if trainer is None:
        trainer = GanTrainer(cfg, vocab_size=dataset.vocab.n_words,
                             device=device, mesh=mesh)
    start_epoch = 0
    if state is None:
        state = trainer.init_state(run_cfg.seed, rnn=rnn, cnn=cnn)
        state, start_epoch = _maybe_resume(
            state, os.path.join(run_cfg.checkpoint_dir, "gan"), resume, say)

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
        say(f"--resume: checkpoint already at epoch {start_epoch} >= "
            f"--epochs {cfg.epochs}; nothing to train")
    for epoch in range(start_epoch + 1, cfg.epochs + 1):
        for batch in _epoch_batches(dataset, cfg.batch_size, cfg.seq_len,
                                    run_cfg.seed + epoch, dev, mesh=mesh):
            last_embed = (batch["tokens"], batch["lengths"])
            state, metrics = trainer.train_step(state, batch)
            pending.append(metrics)
            timer.tick()
            profiler.tick()
            step_count += 1
            if step_count % run_cfg.log_every == 0:
                _read_back(pending, losses)
                head = {k: round(v[-1], 3) for k, v in losses.items()}
                say(f"epoch {epoch} step {step_count} {head} "
                    f"({timer.steps_per_sec:.2f} steps/s)")
        _read_back(pending, losses)
        # per-epoch snapshot (reference train.py:154-162); the final epoch
        # always saves, even when epochs % checkpoint_every_epochs != 0
        if epoch % run_cfg.checkpoint_every_epochs == 0 or epoch == cfg.epochs:
            save_checkpoint(os.path.join(run_cfg.checkpoint_dir, "gan"),
                            state, state.step, cfg, epoch=epoch, mesh=mesh)
            if last_embed is not None and mesh.is_main:
                _sample_grid(trainer, state, last_embed, fixed_noise,
                             epoch, run_cfg)
            for name in ("g_total", f"d_loss_{cfg.resolutions[-1]}"):
                if losses.get(name) and mesh.is_main:
                    plot_history(losses[name],
                                 os.path.join(run_cfg.image_dir,
                                              f"epoch_{epoch}-{name}.png"))
        say(f"===== epoch {epoch} done =====")
    profiler.close()
    return trainer, state, dict(losses)


def _sample_grid(trainer: GanTrainer, state: GanState, last_embed,
                 fixed_noise: torch.Tensor, epoch: int,
                 run_cfg: RunConfig) -> None:
    """Fixed-noise evaluation grid + word-attention strips of the first
    sample, like reference train.py:154-158 + the attention viewers. The
    eval-mode cascade (``GanTrainer.generate``) leaves the generator in the
    mode it found it in. On a mesh, rank 0 draws it alone from its own
    rows, the first of the global batch (eval BN takes no collective)."""
    tokens, lengths = last_embed
    fixed_noise = fixed_noise[:tokens.shape[0]]
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
