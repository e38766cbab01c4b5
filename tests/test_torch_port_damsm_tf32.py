"""The error of the DAMSM kernels' 3xTF32 products, stated on the CPU.

The tensor-core forward and backward pass (csrc/damsm_similarity.cu,
damsm_fwd_tc_kernel and damsm_bwd_tc_kernel) run every product of the
chain as TF32 mma: each fp32 operand x is split into
hi (11 significant bits, round to nearest: Veltkamp's split at 2^13 + 1)
and lo = x - hi, which the tensor cores read truncated to TF32; a product
adds lo.hi + hi.lo + hi.hi in fp32 and drops lo.lo. Here every
``torch.einsum`` of ``similarity_plain`` and ``similarity_bwd_plain`` is
rounded that way, at the pretrain step's full width (L=8, R=289, D=256,
batch 4), and held against the fp32 plain version with chip_smoke.py's
tolerances: sims within SIMS_TOL, gradients within GRAD_RTOL plus
GRAD_ATOL_SHARE of the largest entry, and EXTREME_TOL with one text's
scores at ~1e3. 1xTF32 (hi.hi alone) misses them: that is why the kernels
split.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.ops.damsm_similarity import (
    similarity_bwd_plain,
    similarity_plain,
)

L, R, D, B = 8, 289, 256, 4


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest at 11 significant bits (Veltkamp's split)."""
    t = x * 8193.0
    return t - (t - x)


def _tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with the 13 low mantissa bits cleared, as the tensor cores read
    an fp32 operand."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _rounded_einsum(three: bool):
    plain = torch.einsum

    def einsum(eq, a, b):
        a_hi, b_hi = _tf32_hi(a), _tf32_hi(b)
        out = plain(eq, a_hi, b_hi)
        if three:
            small = (plain(eq, _tf32_truncate(a - a_hi), b_hi)
                     + plain(eq, a_hi, _tf32_truncate(b - b_hi)))
            out = small + out
        return out
    return einsum


def _inputs(extreme: bool):
    rng = np.random.default_rng(6)
    img = rng.standard_normal((B, R, D)).astype(np.float32)
    words = rng.standard_normal((B, L, D)).astype(np.float32)
    if extreme:                      # text 0's scores ~ +-1e3, the rest O(1)
        words[0] *= 250.0
    lengths = np.array([L, 5, 1, 3])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    g = rng.standard_normal((B, B)).astype(np.float32)
    return [torch.from_numpy(a) for a in (img, words, mask, g)]


def _close(got, want, extreme: bool) -> bool:
    for a, b in zip(got, want):
        tol = chip_smoke.EXTREME_TOL if extreme else dict(
            rtol=chip_smoke.GRAD_RTOL,
            atol=chip_smoke.GRAD_ATOL_SHARE * float(b.abs().max()))
        if not torch.allclose(a, b, **tol):
            return False
    return True


def _backward(monkeypatch, args, three=None):
    with monkeypatch.context() as m:
        if three is not None:
            m.setattr(torch, "einsum", _rounded_einsum(three))
        return similarity_bwd_plain(*args)


def _forward(monkeypatch, args, three=None):
    with monkeypatch.context() as m:
        if three is not None:
            m.setattr(torch, "einsum", _rounded_einsum(three))
        return similarity_plain(*args[:3])


def _sims_tol(extreme: bool) -> dict:
    return chip_smoke.EXTREME_TOL if extreme else chip_smoke.SIMS_TOL


def test_tf32_split_is_exact_in_two_parts():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32) * 100)
    hi = _tf32_hi(x)
    assert bool(((hi.view(torch.int32) & 8191) == 0).all())   # TF32 values
    lo = x - hi
    assert torch.equal(hi + lo, x)
    assert float((lo.abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("extreme", [False, True])
def test_3xtf32_backward_within_the_chip_tolerances(monkeypatch, extreme):
    args = _inputs(extreme)
    want = _backward(monkeypatch, args)
    got = _backward(monkeypatch, args, three=True)
    assert _close(got, want, extreme)


def test_1xtf32_backward_misses_them(monkeypatch):
    results = []
    for extreme in (False, True):
        args = _inputs(extreme)
        want = _backward(monkeypatch, args)
        results.append(_close(_backward(monkeypatch, args, three=False),
                              want, extreme))
    assert not any(results)


@pytest.mark.parametrize("extreme", [False, True])
def test_3xtf32_forward_within_the_chip_tolerances(monkeypatch, extreme):
    """Max abs error 4.8e-7 on sims of up to 4.5 in both cases."""
    args = _inputs(extreme)
    want = _forward(monkeypatch, args)
    got = _forward(monkeypatch, args, three=True)
    torch.testing.assert_close(got, want, **_sims_tol(extreme))


def test_1xtf32_forward_misses_sims_tol_but_not_extreme_tol(monkeypatch):
    """1xTF32 sims are off by 1.5e-4 (1.0e-3 relative): ten times SIMS_TOL.
    With scores of ~1e3 the error, 2.5e-4, is inside the looser
    EXTREME_TOL; the normal case alone rules 1xTF32 out."""
    results = []
    for extreme in (False, True):
        args = _inputs(extreme)
        want = _forward(monkeypatch, args)
        got = _forward(monkeypatch, args, three=False)
        results.append(torch.allclose(got, want, **_sims_tol(extreme)))
    assert results == [False, True]
