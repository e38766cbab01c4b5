"""The memory form's work from its shapes: DM-GAN's key-value memory read
and response gate (csrc/word_attention.cu's ``memread_stream_kernel``).

Per pixel: unscaled scores over the L words and the value read, 2 L C
operations each; the gate's dot over [r; o] and its blend, 7 C. Bytes,
each counted once: the pixel rows r read (C), the (B, L, C) keys and
values read, the int32 mask and the gate's 2C + 1 fp32 values read, the
2C output written and the fp32 (B, L, P) attention maps written. The
bound is the larger of the operations at the bf16 peak and the bytes at
the HBM rate.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from perfbench.counts.kernels import bound_s
from perfbench.counts import PEAK_BF16_FLOPS


def memread_flops(b: int, h: int, w: int, c: int, l: int) -> float:
    return float(b * h * w * (4 * l * c + 7 * c))


def memread_bytes(b: int, h: int, w: int, c: int, l: int,
                  elem: int = 2) -> int:
    p = h * w
    return (elem * (b * p * c + 2 * b * l * c + b * p * 2 * c)
            + 4 * (b * l * p + b * l + 2 * c + 1))


def memread_bound_s(b: int, h: int, w: int, c: int, l: int,
                    elem: int = 2) -> float:
    return bound_s(memread_flops(b, h, w, c, l),
                   memread_bytes(b, h, w, c, l, elem), PEAK_BF16_FLOPS)


def serve_memory_reads(rows: int, gf: int, seq_len: int, num_stages: int
                       ) -> Iterable[Tuple[int, int, int, int, int]]:
    """(B, H, W, C, L) of each memory read a serving call runs: one a next
    stage, on the previous stage's gf-wide map at 64^2, then 128^2."""
    h = 64
    for _ in range(2, num_stages + 1):
        yield rows, h, h, gf, seq_len
        h *= 2
