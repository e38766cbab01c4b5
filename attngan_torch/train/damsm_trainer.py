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
itself).

The JAX step's options, each the same differentiated tail
(``_damsm_update``, so the words loss goes through the kernels on the GPU)
behind another trunk forward:
- ``train_step_cached``: trunk features of ``precompute_trunk_features``
  (``DamsmConfig.cache_region_features``), no trunk at all;
- ``train_step_super``: one eval trunk forward at ``superbatch`` x
  ``batch_size`` rows, then that many sequential steps on its chunks,
  drawing dropout from the state's generator as the plain steps would;
- ``trunk_train_mode_bn``: the unfolded trunk in train mode (the
  reference never calls eval() on it), whose BN moves the running
  statistics; the folded copy is then stale and is dropped.
``iter_attention_maps`` / ``populate_attention_maps`` are the reference's
``populate_attnmaps``. The int8 trunk is a later slice of the port.

Data parallel (``mesh`` of n > 1 ranks, parallel/mesh.py): each rank's
batch is its rows of the global batch. The words + sentence loss is the
sharded one (losses/damsm_sharded.py: K4 and K6 on this rank's images x
all texts), the match labels are the global batch's, the BiLSTM's dropout
mask is drawn at the global batch and sliced, the train-mode trunk's BN
takes the global batch's statistics, and the gradients are averaged over
the ranks BEFORE the BiLSTM's clip, whose norm is then the global
gradient's: every rank takes the step one process takes on the whole
batch.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from attngan_torch.core.config import DamsmConfig
from attngan_torch.core.runtime import compute_dtype, resolve_device
from attngan_torch.data.dataset import (
    pinned_batch,
    preprocess_pyramid,
    word_mask,
)
from attngan_torch.data.prefetch import prefetch
from attngan_torch.losses.damsm import damsm_loss
from attngan_torch.losses.damsm_sharded import make_sharded_damsm_loss
from attngan_torch.models.cnn_encoder import (
    InceptionV3Trunk,
    freeze_trunk,
    make_image_encoder,
)
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.ops.attention import damsm_attention
from attngan_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean_,
    sync_batch_norm_,
)
from attngan_torch.utils.imaging import save_attention_maps

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
                 device: str | torch.device | None = None,
                 mesh: Optional[Mesh] = None):
        # attngan_tpu/train/damsm_trainer.py:78-91
        if cfg.cache_region_features and cfg.trunk_train_mode_bn:
            raise ValueError(
                "cache_region_features assumes a step-invariant trunk forward;"
                " trunk_train_mode_bn makes features depend on batch "
                "composition — pick one")
        if cfg.superbatch > 1 and cfg.trunk_train_mode_bn:
            raise ValueError(
                "superbatch amortizes ONE eval-mode trunk forward over "
                "several steps; trunk_train_mode_bn needs per-step batch "
                "stats — pick one")
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg.compute_dtype)
        # attngan_tpu/train/damsm_trainer.py:68-76
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.sharded_loss = None
        if self.mesh is not None:
            self.sharded_loss = make_sharded_damsm_loss(
                self.mesh, cfg.gamma1, cfg.gamma2, cfg.gamma3, cfg.wlambda,
                cfg.slambda, fused=cfg.fused_similarity)

    @property
    def shard(self) -> Tuple[int, int]:
        """(this rank's index, the number of ranks)."""
        return (0, 1) if self.mesh is None else (self.mesh.rank,
                                                 self.mesh.size)

    # ---- init ----

    def init_state(self, seed: int = 0,
                   pretrained_cnn: Optional[Dict[str, torch.Tensor]] = None
                   ) -> DamsmState:
        """Random weights from ``seed`` (the global RNG is left as it was).
        ``pretrained_cnn``: a trunk state_dict (convert.load_pretrained_trunk
        of a torchvision Inception-v3 file) loaded strictly over the random
        trunk."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            rnn = BiLSTMEncoder(self.vocab_size, cfg.text_emb_dim,
                                cfg.emb_dim, cfg.dropout)
            cnn = make_image_encoder(cfg.image_encoder, cfg.emb_dim,
                                     self.dtype)
        if pretrained_cnn is not None:
            if not isinstance(cnn.trunk, InceptionV3Trunk):
                raise ValueError(
                    "pretrained_cnn is an Inception-v3 trunk; the "
                    f"{cfg.image_encoder!r} image encoder has none")
            cnn.trunk.load_state_dict(pretrained_cnn, strict=True)
        rnn.to(self.device)
        cnn.to(self.device).eval()
        cnn.trunk.requires_grad_(False)
        sync_batch_norm_(cnn.trunk, self.mesh)   # train-mode BN only
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
        img = torch.as_tensor(batch["img256"]).to(self.device)
        if self.cfg.trunk_train_mode_bn:
            regions, pooled = self._train_mode_trunk_forward(state, img)
        else:
            regions, pooled = self._eval_trunk_forward(state, img)
        return state, self._damsm_update(state, batch, regions, pooled)

    def train_step_cached(self, state: DamsmState, batch: Dict[str, object]
                          ) -> Tuple[DamsmState, Dict[str, torch.Tensor]]:
        """One step against cached trunk features. batch: tokens, lengths,
        class_ids, trunk_regions (B, R, F) and trunk_pooled (B, F2), rows of
        ``precompute_trunk_features`` (cast to fp32 here)."""
        dev = self.device
        regions = torch.as_tensor(batch["trunk_regions"]).to(dev).float()
        pooled = torch.as_tensor(batch["trunk_pooled"]).to(dev).float()
        return state, self._damsm_update(state, batch, regions, pooled)

    def train_step_super(self, state: DamsmState, batch: Dict[str, object]
                         ) -> Tuple[DamsmState, Dict[str, torch.Tensor]]:
        """``cfg.superbatch`` = K steps in one call: batch holds K x
        batch_size rows (K batches concatenated); the frozen trunk runs once
        over all of them (eval BN: each image's features are the same
        function of its pixels in any batch, though cuDNN may round them
        otherwise in bf16 at K x B rows than at B), then K sequential steps
        on the B-row chunks, each with its own host lengths and its own
        dropout draw. Metrics come back with a leading dimension K. Under
        a mesh the rows are this rank's of each of the K global batches."""
        k, b = self.cfg.superbatch, self.cfg.batch_size // self.shard[1]
        kb = batch["tokens"].shape[0]
        if kb != k * b:
            raise ValueError(f"superbatch step expects {k}x{b} rows, got {kb}")
        img = torch.as_tensor(batch["img256"]).to(self.device)
        regions, pooled = self._eval_trunk_forward(state, img)
        metrics = []
        for i in range(k):
            rows = slice(i * b, (i + 1) * b)
            chunk = {key: batch[key][rows]
                     for key in ("tokens", "lengths", "class_ids")
                     if batch.get(key) is not None}
            metrics.append(self._damsm_update(state, chunk, regions[rows],
                                              pooled[rows]))
        return state, {key: torch.stack([m[key] for m in metrics])
                       for key in metrics[0]}

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

    # ---- cached trunk features (cfg.cache_region_features) ----

    def precompute_trunk_features(self, state: DamsmState, dataset,
                                  batch_size: int = 0,
                                  cache_dtype=np.float16
                                  ) -> Dict[str, np.ndarray]:
        """The frozen eval trunk over ``dataset.records`` in record order
        (each record's pixels and flip through the 256 level of the
        pyramid), on the trainer's device: host arrays {"regions" (N, R, F),
        "pooled" (N, F2)} in ``cache_dtype``. fp16 holds ~0.43 MB an image
        at full width and shifts the cached step's loss by O(1e-3)
        relative; np.float32 keeps the trunk's values. Raises if a value
        does not fit ``cache_dtype`` (fp16 overflows where bf16 does not)."""
        batch_size = batch_size or self.cfg.batch_size
        dtype = getattr(torch, np.dtype(cache_dtype).name)
        out: Dict[str, list] = {"regions": [], "pooled": []}
        records = dataset.records
        for start in range(0, len(records), batch_size):
            recs = records[start:start + batch_size]
            pixels = torch.from_numpy(dataset._batch_pixels(recs))
            flip = torch.tensor([r.flip for r in recs])
            img = preprocess_pyramid(pixels.to(self.device),
                                     flip.to(self.device))[256]
            for key, t in zip(out, self._eval_trunk_forward(state, img)):
                t = t.to(dtype)
                if not bool(torch.isfinite(t).all()):
                    raise ValueError(
                        f"trunk {key} features of records {start}.."
                        f"{start + len(recs) - 1} overflow {dtype}; cache "
                        "them in float32")
                out[key].append(t.cpu().numpy())
        return {key: np.concatenate(parts) for key, parts in out.items()}

    # ---- word-region attention maps (reference populate_attnmaps) ----

    def iter_attention_maps(self, state: DamsmState, dataset,
                            batch_size: int = 0, limit: int = 0
                            ) -> Iterator[np.ndarray]:
        """Yield each image's DAMSM word-region attention maps as a host
        (L, side, side) fp32 array, in record order (ragged last batch
        dropped, as ``iter_batches`` drops it): the eval encoders, then
        ``damsm_attention`` of the words over the regions with the padded
        words masked (reference pretrain_damsm.py:85-107). Batches come
        through the prefetch thread; ``limit`` > 0 stops after that many
        images and ends the thread."""
        batch_size = batch_size or self.cfg.batch_size
        dev = self.device
        yielded = 0
        with contextlib.closing(prefetch(
                dataset.iter_batches(batch_size, self.seq_len,
                                     shuffle=False),
                lambda b: pinned_batch(b, dev))) as batches:
            for host in batches:
                batch = dataset.device_batch(host, dev)
                regions, _ = self.encode_image(state, batch["img256"])
                words, _ = self.encode_text(state, batch["tokens"],
                                            batch["lengths"])
                mask = word_mask(batch["lengths"].to(dev), self.seq_len)
                with torch.no_grad():
                    _, attn = damsm_attention(words, regions,
                                              self.cfg.gamma1, mask=mask)
                attn = attn.cpu().numpy()                   # (B, L, R)
                side = math.isqrt(attn.shape[-1])
                for maps in attn:
                    yield maps.reshape(-1, side, side)
                    yielded += 1
                    if limit and yielded >= limit:
                        return

    def populate_attention_maps(self, state: DamsmState, dataset,
                                folder: str = "attention_maps",
                                batch_size: int = 0, limit: int = 0) -> int:
        """Write each image's maps as ``folder/attn_{i:06d}.png``, a strip
        of its words' maps (``save_attention_maps``). Returns the number
        of images written."""
        os.makedirs(folder, exist_ok=True)
        written = 0
        for maps in self.iter_attention_maps(state, dataset, batch_size,
                                             limit):
            save_attention_maps(maps, os.path.join(folder,
                                                   f"attn_{written:06d}.png"))
            written += 1
        return written

    # ---- the step's parts ----

    @staticmethod
    def _flat_regions(regions: torch.Tensor, pooled: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A trunk's (B, F, 17, 17), (B, F2) -> (B, 289, F), (B, F2), fp32."""
        b, f = regions.shape[:2]
        return (regions.permute(0, 2, 3, 1).reshape(b, -1, f).float(),
                pooled.float())

    def _eval_trunk_forward(self, state: DamsmState, img256: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frozen eval-mode trunk: (regions (B, 289, F), pooled (B, F2)),
        fp32, outside autograd."""
        if state.frozen_trunk is None:
            state.frozen_trunk = freeze_trunk(state.cnn.trunk, self.device)
        with torch.no_grad():
            return self._flat_regions(
                *state.frozen_trunk(img256.permute(0, 3, 1, 2)))

    def _train_mode_trunk_forward(self, state: DamsmState,
                                  img256: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The unfolded trunk in train mode, outside autograd: BN
        normalises by the batch's statistics and moves the running ones
        (momentum 0.1, unbiased variance). The trunk goes back to eval, so
        that ``encode_image`` stays eval, and the folded copy, whose
        statistics are now stale, is dropped, to be refolded at its next
        use."""
        trunk = state.cnn.trunk
        trunk.train()
        try:
            with torch.no_grad():
                out = trunk(img256.permute(0, 3, 1, 2))
        finally:
            trunk.eval()
        state.frozen_trunk = None
        return self._flat_regions(*out)

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

    def _damsm_update(self, state: DamsmState, batch: Dict[str, object],
                      trunk_regions: torch.Tensor, trunk_pooled: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """The differentiated tail of every step form: the train-mode
        BiLSTM on the batch's captions, the heads on the trunk's features,
        the loss, backward, the gradients' mean over the ranks, clip of the
        BiLSTM's gradients, Adam."""
        cfg, dev = self.cfg, self.device
        index, count = self.shard
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        lengths = torch.as_tensor(batch["lengths"])   # packing reads them
        class_ids = batch.get("class_ids")            # on the host
        if class_ids is not None:
            class_ids = torch.as_tensor(class_ids).to(dev)
        b = tokens.shape[0]
        labels = torch.arange(index * b, (index + 1) * b, device=dev)
        mask = word_mask(lengths.to(dev), self.seq_len)
        state.rnn.train()
        words, sent = state.rnn(tokens, lengths, generator=state.generator,
                                shard=self.shard)
        regions, code = self._apply_heads(state, trunk_regions, trunk_pooled)
        if self.sharded_loss is not None:
            total, parts = self.sharded_loss(regions, code, words, sent,
                                             labels, mask, class_ids)
        else:
            total, parts, _ = damsm_loss(
                regions, code, words, sent, labels, mask, class_ids,
                cfg.gamma1, cfg.gamma2, cfg.gamma3, cfg.wlambda, cfg.slambda,
                fused=cfg.fused_similarity, attention_maps=False)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        trainable = state.trainable()
        all_reduce_mean_([p.grad for _, p in trainable], self.mesh)
        grads = [p.grad for name, p in trainable if name.startswith("rnn.")]
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(cfg.rnn_grad_clip / gnorm.clamp_min(1e-12),
                            max=1.0)
        torch._foreach_mul_(grads, scale)
        state.optimizer.step()
        state.step += 1
        return {"loss": total.detach(), "rnn_grad_norm": gnorm.detach(),
                **{k: v.detach() for k, v in parts.items()}}
