"""What the resident-weight K2 kernel takes from Python, checked on the CPU.

csrc/upblock.cu::upblock_resident_kernel runs only on the card (marker
``cuda`` in tests/test_torch_cuda_kernels.py holds it against the plain
version). Its B operand and its work-unit plan are made in Python, in
ops/cuda_upblock.py: the arranged weights must unpack to the parity weights
exactly, and the persistent blocks' units must cover every output pixel
exactly once, ragged edges included. Which of csrc/upblock.cu's kernels
a launch takes is a pure function of the type and the dims (``form``), and
what the kernels do not take is refused before a launch
(``check_inputs``): both are checked here.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.cuda_upblock import (
    RESIDENT_DIMS,
    UNIT_COLS,
    UNIT_ROWS,
    check_inputs,
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


def test_resident_counter_untouched_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 64)).astype(
        np.float32)).bfloat16()
    weight = torch.from_numpy(
        (rng.standard_normal((64, 64, 3, 3)) * 0.05).astype(np.float32))
    k, b = torch.ones(64), torch.zeros(64)
    before = (upblock_fused_eval_cuda.launches,
              upblock_fused_eval_cuda.resident_launches)
    assert torch.equal(upblock_fused_eval_cuda(x, weight, k, b),
                       upblock_fused_eval(x, weight, k, b))
    assert (upblock_fused_eval_cuda.launches,
            upblock_fused_eval_cuda.resident_launches) == before


# --- which kernel, and what none of them takes ------------------------------

@pytest.mark.parametrize("dtype,ci,co,want", [
    (torch.bfloat16, 64, 32, "resident"), (torch.bfloat16, 128, 64, "mma"),
    (torch.bfloat16, 32, 16, "mma"), (torch.float32, 64, 32, "cuda_cores"),
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
