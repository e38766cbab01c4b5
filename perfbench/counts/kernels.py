"""The least time the chip needs for the work of the port's hand-written
kernels, from their shapes: the larger of operations over the peak rate
and bytes over the HBM rate. Each input byte is counted read once, each
output byte written once.

K2, the eval UpBlock (2x nearest upsample -> conv3x3 -> BN -> GLU): a
nearest upsample followed by a 3x3 conv is, at each output parity, a 2x2
conv of the input, so the operations the output needs are
2 * B * (2H)(2W) * 2Co * Ci * 4; bytes are the input, the weights and the
output in bf16 (the folded BN's scale and bias in fp32).
"""

from __future__ import annotations

from typing import Iterable, Tuple

from perfbench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def upblock_bound_s(b: int, h: int, w: int, ci: int, co: int,
                    elem: int = 2) -> float:
    flops = 2.0 * b * (2 * h) * (2 * w) * (2 * co) * ci * 4
    nbytes = (elem * (b * h * w * ci + 2 * co * ci * 9
                      + b * 4 * h * w * co) + 4 * 2 * 2 * co)
    return bound_s(flops, nbytes, PEAK_BF16_FLOPS)


def serve_upblocks(rows: int, gf: int, num_stages: int
                   ) -> Iterable[Tuple[int, int, int, int, int]]:
    """(B, H, W, Ci, Co) of each UpBlock a serving call runs through K2:
    those of the next stages, at 64^2 and above."""
    h = 64
    for _ in range(2, num_stages + 1):
        yield rows, h, h, 2 * gf, gf
        h *= 2
