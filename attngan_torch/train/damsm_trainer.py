"""DAMSM pretraining step: port of attngan_tpu/train/damsm_trainer.py.

Per batch: the frozen Inception trunk (eval-mode BatchNorm, in the compute
dtype, under no_grad) -> the trainable heads in fp32 -> the train-mode
BiLSTM -> the DAMSM words + sentence loss (the words loss through the
Hopper kernels K4-K6 on the GPU, ops/cuda_damsm.py) -> backward -> the
gradient norm of the BiLSTM clipped to 0.25 with the JAX formula
(``scale = min(1, clip / max(norm, 1e-12))``, not clip_grad_norm_'s 1e-6
guard) -> one Adam (lr 0.002, betas (0.5, 0.999)) over the BiLSTM and the
heads. Only the trunk's outputs enter the differentiated part, as the JAX
step hoists the trunk out of value_and_grad.

The state lives on one device, the GPU unless the trainer is built with
``device="cpu"``; PyTorch updates it in place, and ``train_step`` returns
it with the step's metrics (0-d tensors, read without a sync by the step
itself). The JAX step's feature cache, superbatch, int8 trunk and
train-mode trunk BN are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from attngan_torch.core.config import DamsmConfig
from attngan_torch.core.runtime import compute_dtype, resolve_device
from attngan_torch.data.dataset import word_mask
from attngan_torch.losses.damsm import damsm_loss
from attngan_torch.models.cnn_encoder import freeze_trunk, make_image_encoder
from attngan_torch.models.rnn_encoder import BiLSTMEncoder

HEADS = ("emb_features", "emb_cnn_code")


@dataclass
class DamsmState:
    """What the step reads and writes. ``cnn`` holds the frozen trunk and
    the trainable heads; ``generator`` is the dropout stream."""

    rnn: BiLSTMEncoder
    cnn: nn.Module
    optimizer: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    frozen_trunk: Optional[nn.Module] = None   # built at first use

    def trainable(self) -> List[Tuple[str, nn.Parameter]]:
        """(name, parameter) of what the optimizer updates, in its order:
        the BiLSTM's, then the two heads'."""
        rnn = [(f"rnn.{k}", p) for k, p in self.rnn.named_parameters()
               if p.requires_grad]
        heads = [(f"cnn.{k}", p) for k, p in self.cnn.named_parameters()
                 if k.split(".")[0] in HEADS]
        return rnn + heads


class DamsmTrainer:
    """Owns the configuration and the step; the weights are in the state."""

    def __init__(self, cfg: DamsmConfig, vocab_size: int, seq_len: int,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg.compute_dtype)

    # ---- init ----

    def init_state(self, seed: int = 0) -> DamsmState:
        """Random weights from ``seed`` (the global RNG is left as it was)."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            rnn = BiLSTMEncoder(self.vocab_size, cfg.text_emb_dim,
                                cfg.emb_dim, cfg.dropout)
            cnn = make_image_encoder(cfg.image_encoder, cfg.emb_dim,
                                     self.dtype)
        rnn.to(self.device)
        cnn.to(self.device).eval()
        cnn.trunk.requires_grad_(False)
        state = DamsmState(rnn, cnn, None,
                           torch.Generator(self.device).manual_seed(seed))
        state.optimizer = torch.optim.Adam(
            [p for _, p in state.trainable()], lr=cfg.lr, betas=cfg.betas,
            eps=1e-8)
        return state

    # ---- public API ----

    def train_step(self, state: DamsmState, batch: Dict[str, object]
                   ) -> Tuple[DamsmState, Dict[str, torch.Tensor]]:
        """One optimisation step. batch: tokens (B, L), lengths (B,),
        class_ids (B,) or None, img256 (B, H, W, 3) in [-1, 1]."""
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        lengths = torch.as_tensor(batch["lengths"])   # packing reads them
        class_ids = batch.get("class_ids")            # on the host
        if class_ids is not None:
            class_ids = torch.as_tensor(class_ids).to(dev)
        img = torch.as_tensor(batch["img256"]).to(dev)
        labels = torch.arange(tokens.shape[0], device=dev)
        mask = word_mask(lengths.to(dev), self.seq_len)
        regions, pooled = self._eval_trunk_forward(state, img)
        return state, self._damsm_update(state, tokens, lengths, class_ids,
                                         regions, pooled, labels, mask)

    def encode_text(self, state: DamsmState, tokens, lengths):
        """Eval-mode BiLSTM: (word_embs (B, L, D), sent_embs (B, D))."""
        state.rnn.eval()
        with torch.no_grad():
            return state.rnn(torch.as_tensor(tokens).to(self.device),
                             torch.as_tensor(lengths))

    def encode_image(self, state: DamsmState, images):
        """The whole encoder in eval mode: (regions (B, 289, D), code (B, D))."""
        with torch.no_grad():
            return state.cnn(torch.as_tensor(images).to(self.device))

    # ---- the step's parts ----

    def _eval_trunk_forward(self, state: DamsmState, img256: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frozen eval-mode trunk: (regions (B, 289, F), pooled (B, F2)),
        fp32, outside autograd."""
        if state.frozen_trunk is None:
            state.frozen_trunk = freeze_trunk(state.cnn.trunk, self.device)
        with torch.no_grad():
            regions, pooled = state.frozen_trunk(img256.permute(0, 3, 1, 2))
        b, f = regions.shape[:2]
        return (regions.permute(0, 2, 3, 1).reshape(b, -1, f).float(),
                pooled.float())

    @staticmethod
    def _apply_heads(state: DamsmState, trunk_regions: torch.Tensor,
                     trunk_pooled: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The trainable heads in fp32: the 1x1 conv as a per-region matmul
        (no bias) and the Linear."""
        w = state.cnn.emb_features.weight
        regions = trunk_regions @ w.reshape(w.shape[0], -1).t()
        dense = state.cnn.emb_cnn_code
        return regions, trunk_pooled @ dense.weight.t() + dense.bias

    def _damsm_update(self, state: DamsmState, tokens, lengths, class_ids,
                      trunk_regions, trunk_pooled, labels, mask
                      ) -> Dict[str, torch.Tensor]:
        """Loss, backward, clip of the BiLSTM's gradients, Adam."""
        cfg = self.cfg
        state.rnn.train()
        words, sent = state.rnn(tokens, lengths, generator=state.generator)
        regions, code = self._apply_heads(state, trunk_regions, trunk_pooled)
        total, parts, _ = damsm_loss(
            regions, code, words, sent, labels, mask, class_ids, cfg.gamma1,
            cfg.gamma2, cfg.gamma3, cfg.wlambda, cfg.slambda,
            fused=cfg.fused_similarity, attention_maps=False)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for name, p in state.trainable()
                 if name.startswith("rnn.")]
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(cfg.rnn_grad_clip / gnorm.clamp_min(1e-12),
                            max=1.0)
        torch._foreach_mul_(grads, scale)
        state.optimizer.step()
        state.step += 1
        return {"loss": total.detach(), "rnn_grad_norm": gnorm.detach(),
                **{k: v.detach() for k, v in parts.items()}}
