"""What the streaming K1 kernel takes from Python, checked on the CPU.

csrc/word_attention.cu::word_attention_stream_kernel runs only on the card
(marker ``cuda`` in tests/test_torch_cuda_kernels.py holds it against the
plain version). Its plan is made in Python, in ops/cuda_attention.py: the
persistent blocks' units must cover every (image, pixel) exactly once, a
tile goes by bulk copy only where its bytes and its address are multiples
of 16, and a block's shared memory must fit. The mask now reaches the
kernel as it is (int32) or as ``mask != 0``; the plain version, which the
wrapper runs for CPU tensors, is held against the Pallas kernel in
interpret mode with int32, bool and float masks, all-padded rows included,
at 1e-5 (the same arithmetic in another summation order).
"""

import numpy as np
import pytest
import torch

from attngan_tpu.ops.pallas_attention import word_attention_pallas

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.attention import word_attention
from attngan_torch.ops.cuda_attention import (
    MAX_STAGES,
    MAX_TILE,
    STAGES,
    SM_SMEM,
    SMEM_LIMIT,
    SMEM_RESERVED,
    block_units,
    chunk_values,
    plan,
    smem_bytes,
    unit_tile,
    word_attention_cuda,
)

SERVING = [(64, 64 * 64, 32, 5, 2), (64, 128 * 128, 32, 5, 2)]
CASES = SERVING + [
    (3, 25, 32, 5, 2),        # P < pt: one short tile an image
    (2, 44, 32, 5, 4),        # P not a multiple of 8
    (3, 231, 32, 13, 2),      # P = 231, odd
    (2, 4096, 32, 5, 4),      # fp32: 8 lanes a pixel, 128-pixel tiles
    (2, 64, 32, 5, 2),        # fewer units than blocks
    (3, 25, 4, 5, 2),         # bf16 C = 4: 8-byte rows, the tail path
    (2, 1000, 12, 32, 2),     # bf16 C % 8 == 4, 32 words
    (1, 7, 12284, 1, 4),      # the widest row the wrapper takes
]


def _hits(b, p, c, l, itemsize, sms=132):
    pl = plan(b, p, c, l, itemsize, sms)
    hits = np.zeros((b, p), np.int64)
    tiles = []
    for block in range(pl.grid):
        for u in block_units(pl, block):
            img, p0, n, bulk = unit_tile(pl, u, p, c * itemsize)
            assert 0 < n <= pl.pt and p0 % pl.pt == 0
            hits[img, p0:p0 + n] += 1
            tiles.append((img, p0, n, bulk))
    return pl, hits, tiles


@pytest.mark.parametrize("b,p,c,l,itemsize", CASES)
def test_units_cover_every_pixel_once(b, p, c, l, itemsize):
    pl, hits, tiles = _hits(b, p, c, l, itemsize)
    assert (hits == 1).all()
    assert len(tiles) == pl.units == b * pl.tiles
    assert pl.grid == min(pl.units, pl.blocks * 132)


@pytest.mark.parametrize("b,p,c,l,itemsize", CASES)
def test_bulk_tiles_are_whole_16_byte_runs(b, p, c, l, itemsize):
    _, _, tiles = _hits(b, p, c, l, itemsize)
    row = c * itemsize
    for img, p0, n, bulk in tiles:
        aligned = (img * p + p0) * row % 16 == 0 and n * row % 16 == 0
        assert bulk == aligned
    if row % 16 == 0:              # fp32, bf16 at C % 8 == 0: never a tail
        assert all(t[3] for t in tiles)


def test_tail_path_takes_only_the_unaligned_tiles():
    # bf16, C = 4 (8-byte rows), P = 25: odd images start 8 bytes off a
    # 16-byte boundary and every tile has an odd byte count of 8s
    _, _, tiles = _hits(3, 25, 4, 5, 2)
    assert [t[3] for t in tiles] == [False, False, False]
    _, _, tiles = _hits(2, 26, 4, 5, 2)
    assert [t[3] for t in tiles] == [True, True]


@pytest.mark.parametrize("b,p,c,l,itemsize", SERVING)
def test_serving_plan(b, p, c, l, itemsize):
    pl = plan(b, p, c, l, itemsize, 132)
    # 4 lanes of 8 bf16 a pixel, 16 KB tiles of 256 pixels, two stages,
    # two blocks an SM
    assert (pl.g, pl.pt, pl.stages, pl.blocks, pl.grid) == (
        4, 256, STAGES, 2, 264)
    assert pl.pt * c * itemsize == 16 * 1024


@pytest.mark.parametrize("b,p,c,l,itemsize", CASES)
def test_plan_fits_shared_memory_and_lanes(b, p, c, l, itemsize):
    pl = plan(b, p, c, l, itemsize, 132)
    v = chunk_values(c, itemsize)
    assert v * itemsize in (8, 16) and c % v == 0
    assert pl.g & (pl.g - 1) == 0 and pl.g <= min(32, c // v)
    assert 2 * pl.g > min(32, c // v)          # the largest such power of 2
    assert 1 <= pl.pt <= MAX_TILE and 2 <= pl.stages <= MAX_STAGES
    per_pass = 8 * (32 // pl.g) * (2 if l <= 8 else 1)
    assert pl.pt % per_pass == 0 or pl.pt < per_pass or pl.pt >= p
    smem = smem_bytes(c, l, itemsize, pl.pt, pl.g, pl.stages)
    assert smem <= min(SMEM_LIMIT, SM_SMEM // pl.blocks - SMEM_RESERVED)
    assert pl.blocks == 2 or smem_bytes(c, l, itemsize, pl.pt, pl.g,
                                        2) > SM_SMEM // 2 - SMEM_RESERVED


def _masked_case(rng, kind):
    b, h, w, c, l = 4, 8, 6, 8, 5
    images = rng.standard_normal((b, h, w, c)).astype(np.float32)
    words = rng.standard_normal((b, l, c)).astype(np.float32)
    lengths = np.array([l, 2, 1, 0])                  # image 3: all padded
    real = np.arange(l)[None] < lengths[:, None]
    mask = {"int32": real.astype(np.int32), "bool": real,
            "float": real.astype(np.float32) * 0.5}[kind]
    return images, words, mask


@pytest.mark.parametrize("kind", ["int32", "bool", "float"])
def test_plain_matches_pallas_interpret_with_any_mask(rng, kind):
    images, words, mask = _masked_case(rng, kind)
    want_ctx, want_attn = word_attention_pallas(images, words, mask,
                                                block_p=16, interpret=True)
    got_ctx, got_attn = word_attention(torch.from_numpy(images),
                                       torch.from_numpy(words),
                                       torch.from_numpy(mask))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                               atol=1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               atol=1e-5)
    # an all-padded caption attends uniformly; padded words get nothing
    np.testing.assert_allclose(got_attn[3].numpy(), 0.2, atol=1e-7)
    assert float(got_attn[2, 1:].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_wrapper_takes_plain_version_on_cpu_with_any_mask(rng, kind):
    images, words, mask = (torch.from_numpy(a)
                           for a in _masked_case(rng, kind))
    before = word_attention_cuda.launches
    got = word_attention_cuda(images, words, mask)
    want = word_attention(images, words, mask)
    assert word_attention_cuda.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
