"""What the resident-weight and cluster K2 kernels take from Python, checked
on the CPU.

csrc/upblock.cu::upblock_resident_kernel and upblock_cluster_kernel run only
on the card (marker ``cuda`` in tests/test_torch_cuda_kernels.py holds them
against the plain version). Their B operand and their work-unit plans are
made in Python, in ops/cuda_upblock.py: the arranged weights must unpack to
the parity weights exactly (each cluster rank's slice to its parity's), the
persistent blocks' units, and the clusters' units with the four ranks'
parities, must cover every output pixel exactly once, ragged edges
included, and each form's shared memory must fit an SM. Which of
csrc/upblock.cu's kernels
a launch takes is a pure function of the type and the dims (``form``), and
what the kernels do not take is refused before a launch
(``check_inputs``): both are checked here.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.cuda_upblock import (
    CLUSTER_DIMS,
    RESIDENT_DIMS,
    UNIT_COLS,
    UNIT_ROWS,
    check_inputs,
    cluster_grid,
    form,
    parity_weights,
    resident_grid,
    resident_units,
    resident_weights,
    upblock_fused_eval,
    upblock_fused_eval_cuda,
)


def unit_origin(u, h, w):
    """(image, first source row, first source column) of unit u, as
    csrc/upblock.cu::res::Unit computes it."""
    units_c = -(-w // UNIT_COLS)
    per_image = -(-h // UNIT_ROWS) * units_c
    rem = u % per_image
    return u // per_image, rem // units_c * UNIT_ROWS, rem % units_c * UNIT_COLS


@pytest.mark.parametrize("ci,co", [(64, 32), (16, 8)])
def test_resident_weights_unpack_to_parity_weights(rng, ci, co):
    weight = torch.from_numpy(
        rng.standard_normal((2 * co, ci, 3, 3)).astype(np.float32))
    wp = parity_weights(weight).to(torch.bfloat16)
    wr = resident_weights(wp)
    # [parity][K/8][N/8][n][k]: core matrices of 8 channels x 8 K values
    assert wr.shape == (4, 4 * ci // 8, 2 * co // 8, 8, 8)
    assert wr.is_contiguous() and wr.dtype == torch.bfloat16
    kg, ng = 5 % (4 * ci // 8), 1
    assert torch.equal(wr[2, kg, ng], wp[2, 8 * kg:8 * kg + 8,
                                         8 * ng:8 * ng + 8].T)
    unpacked = wr.permute(0, 1, 4, 2, 3).reshape(4, 4 * ci, 2 * co)
    assert torch.equal(unpacked, wp)


@pytest.mark.parametrize("b,h,w,sms", [(2, 64, 64, 132), (8, 128, 128, 132),
                                       (2, 20, 36, 132), (3, 17, 40, 7),
                                       (1, 5, 3, 132), (4, 9, 33, 5)])
def test_resident_units_cover_every_output_pixel_once(b, h, w, sms):
    grid = resident_grid(b, h, w, sms)
    units = resident_units(b, h, w)
    assert grid == min(sms, units)
    hits = np.zeros((b, 2 * h, 2 * w), np.int64)
    for block in range(grid):                 # the kernel's static stride
        for u in range(block, units, grid):
            img, r0, c0 = unit_origin(u, h, w)
            assert r0 % UNIT_ROWS == 0 and c0 % UNIT_COLS == 0
            assert r0 < h and c0 < w
            # four parities of each source pixel in the unit, masked at
            # the image's edge as the kernel's stores are
            hits[img, 2 * r0:2 * (r0 + UNIT_ROWS),
                 2 * c0:2 * (c0 + UNIT_COLS)] += 1
    assert (hits == 1).all()


def test_resident_route_is_the_serving_dims():
    assert (64, 32) in RESIDENT_DIMS
    for ci, co in RESIDENT_DIMS:
        assert 2 * co == 64 and ci % 16 == 0          # m64n64k16 consumers
        # four parities of bf16 weights plus four tiles within 227 KB
        assert 4 * 4 * ci * 2 * co * 2 + 4 * ci // 8 * 2960 <= 227 * 1024


SMEM_PER_BLOCK = 232448    # the H100's shared memory a block can use
CLUSTER_CTAS = 4           # CTAs of a cluster of the cluster kernel: rank r
                           # keeps parity r (csrc/upblock.cu::clu::kCluster)


def test_cluster_weights_slice_per_rank(rng):
    ci, co = 128, 64
    assert (ci, co) in CLUSTER_DIMS
    weight = torch.from_numpy(
        rng.standard_normal((2 * co, ci, 3, 3)).astype(np.float32))
    wp32 = parity_weights(weight)
    wp = wp32.to(torch.bfloat16)
    # arranged and cast in one copy, as the wrapper makes it: the same bits
    # as cast, then arranged
    wr = resident_weights(wp32, torch.bfloat16)
    assert wr.is_contiguous() and wr.dtype == torch.bfloat16
    assert torch.equal(wr, resident_weights(wp))
    # CTA rank r copies the r-th CLUSTER_CTAS-th of the bytes: parity r
    flat = wr.reshape(CLUSTER_CTAS, -1)
    for rank in range(CLUSTER_CTAS):
        piece = flat[rank].reshape(4 * ci // 8, 2 * co // 8, 8, 8)
        assert piece.numel() * 2 == 4 * ci * 2 * co * 2     # 128 KB
        assert torch.equal(piece.permute(0, 3, 1, 2).reshape(4 * ci, 2 * co),
                           wp[rank])


@pytest.mark.parametrize("b,h,w,clusters", [
    (64, 64, 64, 32), (64, 128, 128, 33), (2, 20, 36, 32), (3, 17, 40, 7),
    (1, 8, 16, 32), (1, 5, 3, 2), (4, 9, 33, 5), (8, 128, 128, 30)])
def test_cluster_units_and_ranks_cover_every_output_pixel_once(b, h, w,
                                                                clusters):
    grid = cluster_grid(b, h, w, clusters)
    units = resident_units(b, h, w)
    assert grid == min(clusters, units) and grid >= 1
    hits = np.zeros((b, 2 * h, 2 * w), np.int64)
    for cluster in range(grid):            # the kernel's static stride
        for u in range(cluster, units, grid):
            img, r0, c0 = unit_origin(u, h, w)
            assert r0 < h and c0 < w
            rows = slice(2 * r0, 2 * min(r0 + UNIT_ROWS, h))
            cols = slice(2 * c0, 2 * min(c0 + UNIT_COLS, w))
            for rank in range(CLUSTER_CTAS):   # rank r writes parity r
                py, px = divmod(rank, 2)
                block = hits[img, rows, cols]
                block[py::2, px::2] += 1
    assert (hits == 1).all()


def test_cluster_route_fits_an_sm():
    # a plane of a tile, (8+2) x (16+2) pixels x 8 bf16 channels as its TMA
    # box lands, 128-byte aligned for TMA (clu::Shape::kPlaneBytes)
    plane = -(-(UNIT_ROWS + 2) * (UNIT_COLS + 2) * 16 // 128) * 128
    assert plane == 2944
    for ci, co in CLUSTER_DIMS:
        assert 2 * co == 128 and ci % 16 == 0         # m64n128k16 consumers
        assert ci // 8 % CLUSTER_CTAS == 0     # each rank a quarter of the
        # tile's planes
        # one parity's bf16 weights (128 KB), a ring of two tiles, five
        # mbarriers (64 bytes) and the halved BN constants: 226,368 bytes
        smem = 4 * ci * 2 * co * 2 + 2 * ci // 8 * plane + 64 + 4 * co * 4
        assert smem <= SMEM_PER_BLOCK
        # four parities would not fit: the reason for the cluster
        assert 4 * 4 * ci * 2 * co * 2 > SMEM_PER_BLOCK


def test_resident_counter_untouched_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 64)).astype(
        np.float32)).bfloat16()
    weight = torch.from_numpy(
        (rng.standard_normal((64, 64, 3, 3)) * 0.05).astype(np.float32))
    k, b = torch.ones(64), torch.zeros(64)
    before = (upblock_fused_eval_cuda.launches,
              upblock_fused_eval_cuda.resident_launches,
              upblock_fused_eval_cuda.cluster_launches)
    assert torch.equal(upblock_fused_eval_cuda(x, weight, k, b),
                       upblock_fused_eval(x, weight, k, b))
    assert (upblock_fused_eval_cuda.launches,
            upblock_fused_eval_cuda.resident_launches,
            upblock_fused_eval_cuda.cluster_launches) == before


# --- which kernel, and what none of them takes ------------------------------

@pytest.mark.parametrize("dtype,ci,co,want", [
    (torch.bfloat16, 64, 32, "resident"), (torch.bfloat16, 128, 64, "cluster"),
    (torch.bfloat16, 32, 16, "mma"), (torch.bfloat16, 48, 24, "mma"),
    (torch.float32, 64, 32, "cuda_cores"),
    (torch.float32, 128, 64, "cuda_cores"),
    (torch.float32, 16, 8, "cuda_cores")])
def test_form_by_type_and_dims(dtype, ci, co, want):
    assert form(dtype, ci, co) == want


@pytest.mark.parametrize("dtype,ci,co,weight_ci,bn,match", [
    (torch.bfloat16, 8, 8, 8, 16, "Ci=8, Co=8 do not fit"),
    (torch.float32, 16, 2, 16, 4, "Ci=16, Co=2 do not fit"),
    (torch.float32, 16, 8, 32, 16, "does not fit Ci=16"),
    (torch.float32, 16, 8, 16, 8, r"BN constants must be \(16,\)")],
    ids=["bf16_ci8", "co2", "weight_ci", "bn_length"])
def test_check_inputs_refuses_what_no_kernel_takes(dtype, ci, co, weight_ci,
                                                   bn, match):
    x = torch.zeros((1, 4, 4, ci), dtype=dtype)
    weight = torch.zeros((2 * co, weight_ci, 3, 3))
    with pytest.raises(ValueError, match=match):
        check_inputs("upblock_fused_eval_cuda", x, weight, torch.ones(bn),
                     torch.zeros(bn))
