"""GALIP's kernels' work from their shapes: K11, the CLIP blocks' attention
(csrc/clip_attention.cu), and K7's DF layers at GALIP's sizes, its resize
form included (csrc/dfblock.cu).

K11 on a packed (B, L, 3W) in_proj output, W = heads x 64: the scores and
the weighted sum, 2 x 64 operations each a (query, key) pair, so
4 x B x heads x 64 x pairs, with L(L + 1)/2 pairs where the mask is
causal (the text's layers) and L^2 where it is not (the bridge's). Bytes,
each counted once: the (B, L, 3W) input read, the (B, L, W) output
written. The bound is the larger of the operations at the bf16 peak and
the bytes at the HBM rate; bytes bound it.

K7 (counts/dfgan.py's byte model): the input read at its own size, the
output written at the resized size, and the four (B, C) fp32 constants.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from perfbench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from perfbench.counts.kernels import bound_s

HEAD = 64


def clip_attn_flops(b: int, l: int, heads: int, causal: bool) -> float:
    pairs = l * (l + 1) // 2 if causal else l * l
    return float(4 * b * heads * HEAD * pairs)


def clip_attn_bytes(b: int, l: int, heads: int, elem: int = 2) -> int:
    return elem * b * l * heads * HEAD * (3 + 1)


def clip_attn_bound_s(b: int, l: int, heads: int, causal: bool,
                      elem: int = 2) -> float:
    return bound_s(clip_attn_flops(b, l, heads, causal),
                   clip_attn_bytes(b, l, heads, elem), PEAK_BF16_FLOPS)


def serve_attention(rows: int, cfg: dict
                    ) -> Iterable[Tuple[int, int, int, bool]]:
    """(B, L, heads, causal) of each K11 launch a serving call runs: the
    text's layers at CLIP's context, then the bridge's, at grid^2 + 1
    tokens and one more where a prompt rides along."""
    for _ in range(cfg["clip_layers"]):
        yield rows, cfg["seq_len"], cfg["clip_heads"], True
    tokens = cfg["code_size"] ** 2 + 1
    for i in range(cfg["vit_layers"]):
        extra = 1 if i in cfg["prompt_layers"] else 0
        yield rows, tokens + extra, cfg["vit_heads"], False


def dfblock_bytes(b: int, h: int, w: int, ho: int, wo: int, c: int,
                  elem: int = 2) -> int:
    """Bytes of one K7 launch from a (B, H, W, C) input to a (B, Ho, Wo, C)
    output (the same, 2x, or any nearest resize)."""
    return elem * b * c * (h * w + ho * wo) + 4 * 4 * b * c


def dfblock_bound_s(b: int, h: int, w: int, ho: int, wo: int, c: int,
                    elem: int = 2) -> float:
    return dfblock_bytes(b, h, w, ho, wo, c, elem) / PEAK_HBM_BYTES


def serve_df_layers(rows: int, cfg: dict
                    ) -> Iterable[Tuple[int, int, int, int, int, int]]:
    """(B, H, W, Ho, Wo, C) of the DF layers a serving call runs through
    K7: two an M_Block at the code's side (mid_ch, then code_ch), then two
    a G_Block: the first on its input, resized into the block's size, the
    second at that size (channels nf x (8, 8, 8, 4, 2, 1) at 224)."""
    from perfbench.reference.dfgan import channel_pairs
    from perfbench.reference.galip import block_sizes

    g = cfg["code_size"]
    for _ in range(cfg["map_num"]):
        yield rows, g, g, g, g, cfg["mid_ch"]
        yield rows, g, g, g, g, cfg["code_ch"]
    pairs = channel_pairs(cfg["gf_dim"], cfg["imsize"])
    side = g
    for (cin, cout), size in zip(pairs, block_sizes(cfg["imsize"],
                                                    len(pairs))):
        yield rows, side, side, size, size, cin
        yield rows, size, size, size, size, cout
        side = size
