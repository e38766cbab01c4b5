"""The DAMSM loss sharded by image rows over data-parallel ranks: port of
attngan_tpu/losses/damsm_sharded.py.

The (B, B) similarity matrix couples every image to every caption. Each
rank holds its own images and gathers the small text side (words, mask,
sentence, labels, class ids: ~B * L * D floats), computes its rows of the
similarity, local images x all texts, through ops/cuda_damsm.py (K4
forward; the backward of a rectangular (B/n, B) grid is the tiled case,
K6), then gathers the (B, B) rows and the image codes and computes the
symmetric cross entropy and the sentence loss replicated, exactly as
losses/damsm.py does in one process.

Every rank returns the same loss. The gathers' backward sums the
cotangents of every rank, so each rank's gradient is n times its share of
the loss's; the trainers average the gradients over the ranks, which
brings it back to the loss's own.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from attngan_torch.losses.damsm import (
    _class_mask,
    _similarities_plain,
    _symmetric_ce,
    sentence_loss,
)
from attngan_torch.ops.attention import NEG_INF
from attngan_torch.parallel.mesh import Mesh, all_gather_rows


def make_sharded_damsm_loss(mesh: Mesh, gamma1: float = 4.0,
                            gamma2: float = 5.0, gamma3: float = 10.0,
                            wlambda: float = 5.0, slambda: float = 5.0,
                            fused: bool = True):
    """Returns loss_fn(img_features, cnn_code, words_emb, sent_emb, labels,
    word_mask, class_ids) -> (total, {"words_loss", "sentence_loss"}), each
    argument this rank's rows of the global batch (labels: the global
    match labels, arange(B), of these rows). ``fused`` False computes the
    rows through the plain vectorised form instead of ops/cuda_damsm.py."""

    def loss_fn(img_features: torch.Tensor, cnn_code: torch.Tensor,
                words_emb: torch.Tensor, sent_emb: torch.Tensor,
                labels: torch.Tensor, word_mask: torch.Tensor,
                class_ids: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        all_words = all_gather_rows(words_emb, mesh)
        all_mask = all_gather_rows(word_mask, mesh)
        all_sent = all_gather_rows(sent_emb, mesh)
        all_labels = all_gather_rows(labels, mesh)
        all_class = (None if class_ids is None
                     else all_gather_rows(class_ids, mesh))
        # this rank's images x all texts: (B / n, B)
        if fused:
            from attngan_torch.ops.cuda_damsm import damsm_similarity

            rows = damsm_similarity(img_features, all_words, all_mask,
                                    gamma1, gamma2)
        else:
            rows = _similarities_plain(img_features, all_words, all_mask,
                                       gamma1, gamma2)[0].t()
        sims = all_gather_rows(rows, mesh) * gamma3
        if all_class is not None:
            sims = sims.masked_fill(_class_mask(all_class), NEG_INF)
        wloss = _symmetric_ce(sims, all_labels) * wlambda
        sloss = sentence_loss(all_gather_rows(cnn_code, mesh), all_sent,
                              all_labels, all_class, gamma3, slambda)
        return wloss + sloss, {"words_loss": wloss, "sentence_loss": sloss}

    return loss_fn
