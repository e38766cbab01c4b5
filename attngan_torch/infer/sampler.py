"""Batched text -> image inference: port of attngan_tpu/infer/sampler.py.

Tokens -> BiLSTM (fp32) -> word mask -> Generator (eval BatchNorm) ->
denormalize. The noise and the reparametrization eps can be injected (the
JAX package draws them with jax.random, which no torch generator
reproduces); otherwise they come from an explicit ``torch.Generator``.

Data parallel (``Sampler(mesh=)``, JAX's ``Sampler(mesh=)``): every rank
is given the whole batch's tokens, draws the whole batch's noise and eps,
samples its own rows, and the images are gathered (``gather``) so that
rank 0 can write them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from attngan_torch.core.config import SHAPE_FIELDS, GanConfig, replace
from attngan_torch.core.runtime import resolve_device
from attngan_torch.data.dataset import word_mask
from attngan_torch.models.generator import Generator
from attngan_torch.models.rnn_encoder import BiLSTMEncoder
from attngan_torch.parallel.mesh import Mesh, all_gather_rows, shard_rows


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)


class InferState(nn.Module):
    """What sampling touches: the text encoder and the generator."""

    def __init__(self, cfg: GanConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.rnn = BiLSTMEncoder(vocab_size, hidden_dim=cfg.emb_dim)
        self.generator = Generator.from_config(cfg)


def save_infer_state(path: str, state: InferState) -> None:
    """torch.save of the weights with the shape fields that built them."""
    shapes = {k: getattr(state.cfg, k) for k in SHAPE_FIELDS}
    torch.save({"shapes": shapes, "vocab_size": state.vocab_size,
                "state_dict": state.state_dict()}, path)


def load_infer_state(path: str, cfg: Optional[GanConfig] = None,
                     device: str | torch.device | None = None) -> InferState:
    """Rebuild an InferState from ``save_infer_state``'s file. The file's
    shape fields override ``cfg``'s; its other fields (compute dtype, kernel
    switches) are ``cfg``'s."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    cfg = replace(cfg or GanConfig(), **blob["shapes"])
    state = InferState(cfg, blob["vocab_size"])
    state.load_state_dict(blob["state_dict"], strict=True)
    return state.to(resolve_device(device))


class Sampler:
    """Serves an InferState on one device (the GPU unless asked otherwise),
    or this rank's rows of each batch on a mesh of ranks."""

    def __init__(self, state: InferState,
                 device: str | torch.device | None = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.state = state.to(self.device).eval()
        self.cfg = state.cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None

    @torch.no_grad()
    def generate_stages(
        self, tokens, lengths, noise: Optional[torch.Tensor] = None,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, gather: bool = True,
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """([per-stage (B,R,R,3) in [0,1]], [per-attention-stage (B,L,h,w)]).
        On a mesh ``tokens``, ``lengths`` and the given ``noise`` / ``eps``
        are the whole batch's; the outputs are too, or this rank's rows
        only where ``gather`` is False."""
        tokens = torch.as_tensor(tokens, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        n = tokens.shape[0]
        if noise is None:
            noise = torch.randn((n, self.cfg.z_dim), generator=generator,
                                device=self.device)
        if eps is None and self.mesh is not None:   # CondAugment's draw
            eps = torch.randn((n, self.cfg.cond_dim), generator=generator,
                              device=self.device)
        tokens, lengths, noise = (shard_rows(t, self.mesh)
                                  for t in (tokens, lengths, noise))
        word_embs, sent_embs = self.state.rnn(tokens, lengths)
        mask = word_mask(lengths, tokens.shape[1])
        fakes, attns, _, _ = self.state.generator(
            noise.to(self.device), sent_embs, word_embs, mask,
            eps=None if eps is None else shard_rows(eps.to(self.device),
                                                    self.mesh),
            generator=generator)
        images = [denormalize(f) for f in fakes]
        if gather and self.mesh is not None:
            images = [all_gather_rows(x, self.mesh) for x in images]
            attns = [all_gather_rows(a, self.mesh) for a in attns]
        return images, attns

    def generate_from_tokens(self, tokens, lengths, noise=None, eps=None,
                             generator=None, gather: bool = True
                             ) -> torch.Tensor:
        """(B, 256, 256, 3) in [0, 1] (the last stage)."""
        return self.generate_stages(tokens, lengths, noise, eps, generator,
                                    gather)[0][-1]
