"""K7's work from its shapes: DF-GAN's fused DF layer (csrc/dfblock.cu),
lrelu(g1 * lrelu(g0 * x + b0) + b1) with per-(sample, channel) fp32
constants. A few operations a value against its bytes: bound by bytes at
the HBM rate. Counted once each: the input read (the block's input before
the 2x upsample where the layer folds it in), the output written, and the
four (B, C) fp32 constants read.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from perfbench.counts import PEAK_HBM_BYTES


def dfblock_bytes(b: int, h: int, w: int, c: int, upsample: bool,
                  elem: int = 2) -> int:
    """Bytes of one launch on a (B, H, W, C) input; the output is (B, 2H,
    2W, C) with ``upsample``."""
    out_pixels = 4 * h * w if upsample else h * w
    return elem * b * c * (h * w + out_pixels) + 4 * 4 * b * c


def dfblock_bound_s(b: int, h: int, w: int, c: int, upsample: bool,
                    elem: int = 2) -> float:
    return dfblock_bytes(b, h, w, c, upsample, elem) / PEAK_HBM_BYTES


def serve_df_layers(rows: int, nf: int
                    ) -> Iterable[Tuple[int, int, int, int, bool]]:
    """(B, H, W, C, upsample) of the 12 DF layers a serving call runs
    through K7: each G_Block's first on its input before the upsample, its
    second on c1's output (GAN.py's channels nf * (8, 8, 8, 8, 4, 2, 1))."""
    widths = [8 * nf] * 4 + [4 * nf, 2 * nf, nf]
    h = 4
    for cin, cout in zip(widths, widths[1:]):
        yield rows, h, h, cin, True
        yield rows, 2 * h, 2 * h, cout, False
        h *= 2
