"""DAMSM word- and sentence-level contrastive losses (AttnGAN Eq. 7-11).

Port of attngan_tpu/losses/damsm.py. Semantics kept:
  * per-word cosine similarity with a 1e-8 norm clamp,
  * Eq. 10 aggregation log(sum_l exp(gamma2 * sim_l)) over real words only,
  * same-class pair masking with the diagonal excluded,
  * gamma3-scaled symmetric cross entropy against the match labels, scaled
    by the w / s lambda.

``words_loss`` has two routes to the same number. ``fused`` runs the
similarity through ops/cuda_damsm.py (the Hopper kernels K4-K6 on a CUDA
tensor, their plain versions on a CPU one); the other route is the plain
vectorised form of the JAX package's vmap, differentiated by autograd.
``fused=None`` takes the kernels for a CUDA tensor. The diagonal attention
maps cost a second attention pass; JAX drops them under jit when nothing
reads them, so here the caller says whether it wants them
(``attention_maps``), and the train step does not.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from attngan_torch.ops.attention import NEG_INF, damsm_attention

EPS = 1e-8


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor,
                      dim: int = -1) -> torch.Tensor:
    """dot / max(|x1| |x2|, eps)."""
    w12 = (x1 * x2).sum(dim)
    w1 = torch.linalg.vector_norm(x1, dim=dim)
    w2 = torch.linalg.vector_norm(x2, dim=dim)
    return w12 / (w1 * w2).clamp_min(EPS)


def _class_mask(class_ids: torch.Tensor) -> torch.Tensor:
    """(B, B) True where the pair is a same-class NON-diagonal mismatch."""
    same = class_ids[:, None] == class_ids[None, :]
    eye = torch.eye(class_ids.shape[0], dtype=torch.bool,
                    device=class_ids.device)
    return same & ~eye


def _symmetric_ce(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE(scores, labels) + CE(scores.T, labels), mean over the batch."""
    return F.cross_entropy(scores, labels) + F.cross_entropy(scores.t(), labels)


def _similarities_plain(img_features, words_emb, word_mask, gamma1, gamma2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vmap form written out over a text axis t and an image axis j:
    (sims (Bt, Bi), attention (Bt, Bi, L, R))."""
    bi = img_features.shape[0]
    bt, l, d = words_emb.shape
    query = words_emb[:, None].expand(bt, bi, l, d).reshape(bt * bi, l, d)
    context = img_features[None].expand(bt, *img_features.shape)
    context = context.reshape(bt * bi, *img_features.shape[1:])
    qmask = word_mask[:, None].expand(bt, bi, l).reshape(bt * bi, l)
    weighted, attn = damsm_attention(query, context, gamma1, mask=qmask)
    sim = cosine_similarity(query, weighted).reshape(bt, bi, l)
    wm = word_mask.to(sim.dtype)[:, None]
    sims = torch.log((torch.exp(gamma2 * sim) * wm).sum(-1))
    return sims, attn.reshape(bt, bi, l, -1)


def words_loss(
    img_features: torch.Tensor,         # (B, R, D) region features
    words_emb: torch.Tensor,            # (B, L, D) word embeddings
    labels: torch.Tensor,               # (B,) int match labels (arange)
    word_mask: torch.Tensor,            # (B, L) 1 = real word, 0 = padding
    class_ids: Optional[torch.Tensor],  # (B,) or None
    gamma1: float = 4.0,
    gamma2: float = 5.0,
    gamma3: float = 10.0,
    wlambda: float = 5.0,
    fused: Optional[bool] = None,       # None = the kernels on a CUDA tensor
    attention_maps: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(scalar loss, diagonal attention maps (B, L, R) or None)."""
    if fused is None:
        fused = img_features.device.type == "cuda"
    if fused:
        from attngan_torch.ops.cuda_damsm import words_loss_fused

        loss = words_loss_fused(img_features, words_emb, labels, word_mask,
                                class_ids, gamma1, gamma2, gamma3, wlambda)
        diag_attn = None
        if attention_maps:   # matched pairs only: B cheap attentions
            _, diag_attn = damsm_attention(words_emb, img_features, gamma1,
                                           mask=word_mask)
        return loss, diag_attn

    sims, attns = _similarities_plain(img_features, words_emb, word_mask,
                                      gamma1, gamma2)
    similarities = sims.t() * gamma3                        # (B_img, B_text)
    if class_ids is not None:
        similarities = similarities.masked_fill(_class_mask(class_ids),
                                                NEG_INF)
    loss = _symmetric_ce(similarities, labels) * wlambda
    diag_attn = None
    if attention_maps:   # attention of the matched pair (text i, image i)
        idx = torch.arange(attns.shape[0], device=attns.device)
        diag_attn = attns[idx, idx]
    return loss, diag_attn


def sentence_loss(
    cnn_code: torch.Tensor,             # (B, D) global image code
    rnn_code: torch.Tensor,             # (B, D) sentence embedding
    labels: torch.Tensor,
    class_ids: Optional[torch.Tensor],
    gamma3: float = 10.0,
    slambda: float = 5.0,
) -> torch.Tensor:
    scores = cnn_code.float() @ rnn_code.float().t()
    norms = (torch.linalg.vector_norm(cnn_code, dim=-1)[:, None]
             * torch.linalg.vector_norm(rnn_code, dim=-1)[None, :])
    scores = scores / norms.clamp_min(EPS) * gamma3
    if class_ids is not None:
        scores = scores.masked_fill(_class_mask(class_ids), NEG_INF)
    return _symmetric_ce(scores, labels) * slambda


def damsm_loss(
    img_features: torch.Tensor,
    cnn_code: torch.Tensor,
    words_emb: torch.Tensor,
    sent_emb: torch.Tensor,
    labels: torch.Tensor,
    word_mask: torch.Tensor,
    class_ids: Optional[torch.Tensor],
    gamma1: float = 4.0,
    gamma2: float = 5.0,
    gamma3: float = 10.0,
    wlambda: float = 5.0,
    slambda: float = 5.0,
    fused: Optional[bool] = None,
    attention_maps: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """The words + sentence loss of both training phases:
    (total, {"words_loss", "sentence_loss"}, attention maps or None)."""
    wloss, attn = words_loss(img_features, words_emb, labels, word_mask,
                             class_ids, gamma1, gamma2, gamma3, wlambda,
                             fused=fused, attention_maps=attention_maps)
    sloss = sentence_loss(cnn_code, sent_emb, labels, class_ids, gamma3,
                          slambda)
    return wloss + sloss, {"words_loss": wloss, "sentence_loss": sloss}, attn
