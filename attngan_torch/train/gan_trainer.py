"""GAN training step: port of attngan_tpu/train/gan_trainer.py (``_gan_step``).

Per batch, with the JAX step's update semantics:
  1. the frozen eval-mode BiLSTM embeds the captions, outside autograd;
  2. ONE train-mode generator forward makes the 64/128/256 cascade and
     updates the generator's BN statistics once (the JAX step's
     ``reuse_gen_forward`` form); autograd keeps its graph for the G-step,
     as the reference keeps its retained graph;
  3. each discriminator takes one Adam step on its fakes, detached: a real
     pass, then a fake pass, both in train mode, the BN statistics of the
     second chained on the first;
  4. the generator takes one Adam step on the sum of the adversarial losses
     against the UPDATED discriminators (train mode: their statistics move
     once more, and those are what the state keeps), the DAMSM words +
     sentence loss of the frozen eval-mode image encoder on fake256 (the
     gradient flows through the folded trunk, ``freeze_trunk``, into the
     fakes; the words loss takes the kernels K4 and K5 on the GPU,
     ops/cuda_damsm.py), and the conditioning-augmentation KL.

During the G-side passes the discriminators' parameters take no gradient
(``requires_grad_(False)``), so nothing of the G-step reaches the next
D-step. The generator runs K1 (ops/cuda_attention.py) in its forward on
the GPU; the backward recomputes through the plain version, as the JAX
kernel's VJP does.

The noise, the conditioning-augmentation ``eps`` and the standard loss's
real labels come from the state's ``torch.Generator`` unless the caller
passes them (the JAX step draws them with jax.random, which no torch
generator reproduces). The state lives on one device, the GPU unless the
trainer is built with ``device="cpu"``; PyTorch updates it in place, and
``train_step`` returns it with the step's metrics (0-d tensors, read
without a sync by the step itself).

Data parallel (``mesh`` of n > 1 ranks, parallel/mesh.py), as the JAX
step runs under SPMD: each rank's batch is its rows of the global batch;
the noise, eps and real labels are drawn at the global batch and sliced
(given ones are the global batch's too); the generator's and the
discriminators' train-mode BN take the global batch's statistics; each of
the four optimizers averages its gradients over the ranks before its
step; the coupling is the sharded DAMSM loss (losses/damsm_sharded.py: K4
and K6 on this rank's fakes x all captions); the metrics are averaged over
the ranks. The frozen encoders stay in eval mode. Each rank's local-mean
GAN losses and KL average to the global ones; the replicated DAMSM loss
gives each rank n times its share, which the mean divides back.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from attngan_torch.core.config import GanConfig
from attngan_torch.core.runtime import compute_dtype, resolve_device
from attngan_torch.data.dataset import word_mask
from attngan_torch.losses.damsm import damsm_loss
from attngan_torch.losses.damsm_sharded import make_sharded_damsm_loss
from attngan_torch.losses.gan import (
    kl_loss,
    non_saturating_disc_loss,
    non_saturating_gen_loss,
    standard_disc_loss,
    standard_gen_loss,
)
from attngan_torch.models.cnn_encoder import freeze_trunk, make_image_encoder
from attngan_torch.models.discriminators import Discriminator
from attngan_torch.models.generator import Generator
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean_,
    mean_metrics,
    shard_rows,
    sync_batch_norm_,
)

LOSS_VARIANTS = ("non_saturating", "standard")
# why the GAN step does not train each generator family it refuses (the
# port serves their checkpoints)
UNTRAINED = {
    "dfgan": ("DF-GAN trains with its own objective, a hinge loss with "
              "MA-GP and its own discriminator, which the port does not have"),
    "dmgan": ("the step builds AttnGAN's generator (models/generator.py), "
              "and DM-GAN's memory read on the card is a kernel with no "
              "backward"),
    "galip": ("GALIP trains against a discriminator built on CLIP's frozen "
              "visual tower, with its own objective, which the port does "
              "not have; and K7 and K11 have no backward"),
}


@dataclass
class GanState:
    """What the step reads and writes. ``discs`` and ``disc_optimizers`` are
    keyed by the resolution as a string ("64", "128", "256"); ``rnn`` and
    ``cnn`` are the frozen DAMSM encoders; ``generator`` is the stream of the
    noise, eps and real labels."""

    gen: Generator
    discs: nn.ModuleDict
    gen_optimizer: torch.optim.Adam
    disc_optimizers: Dict[str, torch.optim.Adam]
    rnn: BiLSTMEncoder
    cnn: nn.Module
    generator: torch.Generator
    step: int = 0
    frozen_trunk: Optional[nn.Module] = None   # built at first use


class GanTrainer:
    """Owns the configuration and the step; the weights are in the state."""

    def __init__(self, cfg: GanConfig, vocab_size: int,
                 device: str | torch.device | None = None,
                 mesh: Optional[Mesh] = None):
        if cfg.generator != "attngan":
            raise ValueError(
                f"the GAN step trains AttnGAN's generator only; got "
                f"generator={cfg.generator!r}: "
                f"{UNTRAINED.get(cfg.generator, 'no such family')}")
        if cfg.loss_variant not in LOSS_VARIANTS:
            raise ValueError(f"loss_variant must be one of {LOSS_VARIANTS}; "
                             f"got {cfg.loss_variant!r}")
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg.compute_dtype)
        # attngan_tpu/train/gan_trainer.py:316-324
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.sharded_loss = None
        if self.mesh is not None:
            self.sharded_loss = make_sharded_damsm_loss(
                self.mesh, cfg.gamma1, cfg.gamma2, cfg.gamma3, cfg.wlambda,
                cfg.slambda, fused=cfg.fused_similarity)

    # ---- init ----

    def init_state(self, seed: int = 0, rnn: Optional[BiLSTMEncoder] = None,
                   cnn: Optional[nn.Module] = None) -> GanState:
        """Random generator and discriminators from ``seed`` (the global RNG
        is left as it was). The DAMSM-pretrained text and image encoders
        (a ``DamsmState``'s ``rnn`` and ``cnn``) are copied in frozen;
        without them the encoders are random too."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            gen = Generator.from_config(cfg)
            discs = nn.ModuleDict({
                str(res): Discriminator(cfg.df_dim, res, self.dtype)
                for res in cfg.resolutions})
            rnn = (BiLSTMEncoder(self.vocab_size, hidden_dim=cfg.emb_dim)
                   if rnn is None else copy.deepcopy(rnn))
            cnn = (make_image_encoder(cfg.image_encoder, cfg.emb_dim,
                                      self.dtype)
                   if cnn is None else copy.deepcopy(cnn))
        gen.to(self.device).train()
        discs.to(self.device).train()
        sync_batch_norm_(gen, self.mesh)
        sync_batch_norm_(discs, self.mesh)
        rnn.to(self.device).eval().requires_grad_(False)
        cnn.to(self.device).eval().requires_grad_(False)

        def adam(module: nn.Module, lr: float) -> torch.optim.Adam:
            return torch.optim.Adam(module.parameters(), lr=lr,
                                    betas=cfg.betas, eps=1e-8)

        return GanState(
            gen, discs, adam(gen, cfg.gen_lr),
            {res: adam(d, cfg.disc_lr) for res, d in discs.items()}, rnn, cnn,
            torch.Generator(self.device).manual_seed(seed))

    # ---- public API ----

    def train_step(self, state: GanState, batch: Mapping[str, object],
                   noise: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   real_labels: Optional[Mapping[str, torch.Tensor]] = None,
                   ) -> Tuple[GanState, Dict[str, torch.Tensor]]:
        """One D-step per resolution and one G-step. batch: tokens (B, L),
        lengths (B,), class_ids (B,) or None, img64[, img128, img256]
        (B, R, R, 3) in [-1, 1], this rank's rows under a mesh. ``noise``
        (N, z), ``eps`` (N, cond) and ``real_labels`` ({res: (N,)}, the
        standard loss only), of the global batch N, are drawn from
        ``state.generator`` where not given, in that order."""
        cfg, dev = self.cfg, self.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        lengths = torch.as_tensor(batch["lengths"])   # packing reads them
        class_ids = batch.get("class_ids")            # on the host
        if class_ids is not None:
            class_ids = torch.as_tensor(class_ids).to(dev)
        n = tokens.shape[0] * (1 if self.mesh is None else self.mesh.size)
        mask = word_mask(lengths.to(dev), cfg.seq_len)
        words, sent = self.embed_text(state, tokens, lengths)
        if noise is None:
            noise = torch.randn((n, cfg.z_dim), generator=state.generator,
                                device=dev)
        if eps is None:   # the draw CondAugment makes without one
            eps = torch.randn((n, cfg.cond_dim), generator=state.generator,
                              device=dev)
        state.gen.train()
        state.discs.train()
        fakes, _, mu, logvar = state.gen(
            shard_rows(noise.to(dev), self.mesh), sent, words, mask,
            eps=shard_rows(eps.to(dev), self.mesh))
        fakes = dict(zip(state.discs, fakes))

        metrics = {}
        for res in state.discs:
            labels = None
            if cfg.loss_variant == "standard":
                labels = shard_rows(
                    real_labels[res].to(dev) if real_labels is not None
                    else self._real_labels(state, n), self.mesh)
            metrics[f"d_loss_{res}"] = self._disc_step(
                state, res, torch.as_tensor(batch[f"img{res}"]).to(dev),
                fakes[res].detach(), labels)

        for disc in state.discs.values():
            disc.requires_grad_(False)
        try:
            total, parts = self._gen_loss(state, fakes, mu, logvar, words,
                                          sent, mask, class_ids)
            state.gen_optimizer.zero_grad(set_to_none=True)
            total.backward()
        finally:
            for disc in state.discs.values():
                disc.requires_grad_(True)
        all_reduce_mean_([p.grad for p in state.gen.parameters()], self.mesh)
        state.gen_optimizer.step()
        state.step += 1
        metrics.update(parts)
        metrics["g_total"] = total.detach()
        return state, mean_metrics(metrics, self.mesh)

    def embed_text(self, state: GanState, tokens, lengths
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frozen eval-mode BiLSTM: (word_embs (B, L, D), sent_embs
        (B, D)), outside autograd."""
        state.rnn.eval()
        with torch.no_grad():
            return state.rnn(torch.as_tensor(tokens).to(self.device),
                             torch.as_tensor(lengths))

    def generate(self, state: GanState, noise, sent_embs, word_embs, mask,
                 eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """The eval-mode cascade (BN running statistics; on the GPU the
        UpBlocks at >= 64^2 take K2): the generator's ([per-stage
        (B, R, R, 3)], [attention maps], mu, logvar)."""
        dev = self.device
        was_training = state.gen.training
        state.gen.eval()
        try:
            with torch.no_grad():
                return state.gen(torch.as_tensor(noise).to(dev), sent_embs,
                                 word_embs, torch.as_tensor(mask).to(dev),
                                 eps=None if eps is None else eps.to(dev),
                                 generator=generator)
        finally:
            state.gen.train(was_training)

    # ---- the step's parts ----

    def _real_labels(self, state: GanState, b: int) -> torch.Tensor:
        """U(label_smooth, 1) real labels of the standard loss."""
        smooth = self.cfg.label_smooth
        u = torch.rand(b, generator=state.generator, device=self.device)
        return smooth + (1.0 - smooth) * u

    def _disc_step(self, state: GanState, res: str, real: torch.Tensor,
                   fake: torch.Tensor, real_labels: Optional[torch.Tensor]
                   ) -> torch.Tensor:
        """One Adam step of discriminator ``res``; returns its loss."""
        disc = state.discs[res]
        real_probs = disc(real)
        fake_probs = disc(fake)
        if self.cfg.loss_variant == "standard":
            loss = standard_disc_loss(real_probs, fake_probs, real_labels,
                                      self.cfg.label_smooth)
        else:
            loss = non_saturating_disc_loss(real_probs, fake_probs)
        optimizer = state.disc_optimizers[res]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_mean_([p.grad for p in disc.parameters()], self.mesh)
        optimizer.step()
        return loss.detach()

    def _gen_loss(self, state: GanState, fakes: Dict[str, torch.Tensor], mu,
                  logvar, words, sent, mask, class_ids
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the G-step's total, its parts detached): the adversarial loss of
        each train-mode discriminator, the DAMSM coupling on fake256 and
        the KL."""
        cfg = self.cfg
        gen_loss = (standard_gen_loss if cfg.loss_variant == "standard"
                    else non_saturating_gen_loss)
        parts, total = {}, 0.0
        for res, disc in state.discs.items():
            g = gen_loss(disc(fakes[res]))
            parts[f"g_loss_{res}"] = g.detach()
            total = total + g
        if cfg.resolutions[-1] == 256:
            dloss = self._damsm_coupling(state, fakes["256"], words, sent,
                                         mask, class_ids)
            parts["damsm_loss"] = dloss.detach()
            total = total + dloss
        kl = kl_loss(mu, logvar)
        parts["kl_loss"] = kl.detach()
        return total + kl, parts

    def _damsm_coupling(self, state: GanState, fake256: torch.Tensor, words,
                        sent, mask, class_ids) -> torch.Tensor:
        """The DAMSM words + sentence loss of the frozen eval-mode image
        encoder on the fakes, differentiable in the fakes: the folded trunk
        and the heads in the trunk's dtype, as the encoder computes them."""
        cfg = self.cfg
        if state.frozen_trunk is None:
            state.frozen_trunk = freeze_trunk(state.cnn.trunk, self.device)
        regions, code = state.cnn.heads(
            *state.frozen_trunk(fake256.permute(0, 3, 1, 2)))
        b = fake256.shape[0]
        first = 0 if self.mesh is None else self.mesh.rank * b
        labels = torch.arange(first, first + b, device=self.device)
        if self.sharded_loss is not None:
            return self.sharded_loss(regions, code, words, sent, labels, mask,
                                     class_ids)[0]
        loss, _, _ = damsm_loss(
            regions, code, words, sent, labels, mask, class_ids, cfg.gamma1,
            cfg.gamma2, cfg.gamma3, cfg.wlambda, cfg.slambda,
            fused=cfg.fused_similarity, attention_maps=False)
        return loss
