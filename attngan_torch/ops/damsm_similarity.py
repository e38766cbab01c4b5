"""DAMSM word-region similarity, plain PyTorch: the plain versions of K4-K6.

Port of the chain that attngan_tpu/ops/pallas_damsm.py computes per
(image, text) pair: ``_chain_fwd`` (the forward, K4) and ``_chain_bwd`` (the
hand-derived backward of K5 / K6), vectorised over every pair at once. The
semantics are the kernel's, not the vmap oracle's:

  s   = w . ctx^T / sqrt(D) + bias     bias = -1e9 at padded words (additive)
  a1  = softmax over each text's L words per region, shifted by the group
        max, e1 / max(sum, 1e-8)
  a2  = softmax over the R regions of gamma1 * a1
  v   = a2 . ctx
  cos = w.v / max(|w| |v|, 1e-8)
  sim = log sum_l exp(gamma2 * cos) over the real words only

Layouts: img (Bi, R, D), words (Bt, L, D), mask (Bt, L) -> sims (Bi, Bt),
sims[j, i] = similarity of image j and text i; the two batch axes are
independent. Everything is fp32. The CUDA kernels (ops/cuda_damsm.py,
csrc/damsm_similarity.cu) repeat this arithmetic; these functions are what
the wrapper runs for CPU tensors and what chip_smoke.py holds them against.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from attngan_torch.ops.attention import NEG_INF

EPS = 1e-8


def _chain_fwd(img: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
               gamma1: float, gamma2: float) -> Dict[str, torch.Tensor]:
    """Every intermediate of the forward chain, over all (j, i) pairs:
    (Bi, Bt, L, R) for the attention arrays, (Bi, Bt, L) per word."""
    ctx = img.float()
    w = words.float()
    scale = 1.0 / math.sqrt(ctx.shape[-1])
    bias = torch.where(mask == 0, NEG_INF, 0.0).to(torch.float32)
    s = torch.einsum("tld,jrd->jtlr", w, ctx) * scale + bias[None, :, :, None]
    e1 = torch.exp(s - s.amax(dim=2, keepdim=True))        # per-group shift
    a1 = e1 / e1.sum(dim=2, keepdim=True).clamp_min(EPS)
    t = a1 * gamma1
    e2 = torch.exp(t - t.amax(dim=3, keepdim=True))
    a2 = e2 / e2.sum(dim=3, keepdim=True)
    v = torch.einsum("jtlr,jrd->jtld", a2, ctx)
    num = (w[None] * v).sum(-1)
    wn = torch.sqrt((w * w).sum(-1))[None]                  # (1, Bt, L)
    vn = torch.sqrt((v * v).sum(-1))
    norms = wn * vn
    nc = norms.clamp_min(EPS)
    cos = num / nc
    expg = torch.exp(gamma2 * cos) * mask.to(torch.float32)[None]
    agg = expg.sum(-1)                                      # (Bi, Bt)
    return dict(ctx=ctx, w=w, scale=scale, a1=a1, a2=a2, v=v, num=num, wn=wn,
                vn=vn, norms=norms, nc=nc, expg=expg, agg=agg)


def similarity_plain(img: torch.Tensor, words: torch.Tensor,
                     mask: torch.Tensor, gamma1: float = 4.0,
                     gamma2: float = 5.0) -> torch.Tensor:
    """sims (Bi, Bt) fp32: the plain version of K4."""
    return torch.log(_chain_fwd(img, words, mask, gamma1, gamma2)["agg"])


def similarity_bwd_plain(img: torch.Tensor, words: torch.Tensor,
                         mask: torch.Tensor, g: torch.Tensor,
                         gamma1: float = 4.0, gamma2: float = 5.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_img (Bi, R, D), d_words (Bt, L, D)) for the cotangent g (Bi, Bt):
    the plain version of the K5 / K6 backward, ``_chain_bwd`` with the
    ``agg > 0`` guard (a text with no real word gets a zero gradient)."""
    c = _chain_fwd(img, words, mask, gamma1, gamma2)
    ctx, w, a1, a2, v = c["ctx"], c["w"], c["a1"], c["a2"], c["v"]
    agg, nc, norms = c["agg"], c["nc"], c["norms"]
    g = g.float()
    d_agg = torch.where(agg > 0, g / agg, torch.zeros_like(agg))
    d_cos = d_agg[..., None] * gamma2 * c["expg"]
    d_num = d_cos / nc
    d_norms = torch.where(norms > EPS, -d_cos * c["num"] / (nc * nc),
                          torch.zeros_like(nc))
    d_wn = d_norms * c["vn"]
    d_vn = d_norms * c["wn"]
    d_w = (d_num[..., None] * v
           + d_wn[..., None] * w[None] / c["wn"].clamp_min(EPS)[..., None])
    d_v = (d_num[..., None] * w[None]
           + d_vn[..., None] * v / c["vn"].clamp_min(EPS)[..., None])
    # v = a2 @ ctx
    d_a2 = torch.einsum("jtld,jrd->jtlr", d_v, ctx)
    d_ctx = torch.einsum("jtlr,jtld->jrd", a2, d_v)
    # a2 = softmax over regions of t = gamma1 * a1
    d_t = a2 * (d_a2 - (d_a2 * a2).sum(-1, keepdim=True))
    d_a1 = d_t * gamma1
    # a1 = softmax over each text's words, per region
    d_s = a1 * (d_a1 - (d_a1 * a1).sum(2, keepdim=True))
    # s = scale * (w @ ctx^T) + bias
    d_w = d_w + c["scale"] * torch.einsum("jtlr,jrd->jtld", d_s, ctx)
    d_ctx = d_ctx + c["scale"] * torch.einsum("jtlr,tld->jrd", d_s, w)
    return d_ctx, d_w.sum(0)
