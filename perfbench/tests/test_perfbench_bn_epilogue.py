"""The reader of K8's per-layer metric, ``bn_epilogue_ms.serve``, by hand:
the summed device time of the kernels whose name holds ``bn_epilogue``,
per traced call, and None where none ran (the parent of K8, DF-GAN)."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.trace import Trace

METRIC = "bn_epilogue_ms.serve"


def _readings(ops, calls=2):
    return harness.Readings(Trace(1.0, calls, ops, []), None, 0.0, {})


def test_reader_of_k8_by_hand():
    ops = [("void attngan::bne::bn_epilogue_kernel<__nv_bfloat16, true>"
            "(...)", 0.0, 2e-4),
           ("void attngan::bne::bn_epilogue_kernel<__nv_bfloat16, false>"
            "(...)", 1e-3, 1.4e-3),
           ("sm90_xmma_fprop_implicit_gemm", 2e-3, 4e-3),
           ("Memcpy DtoD", 5e-3, 6e-3)]
    assert harness.reader(METRIC)(_readings(ops)) == pytest.approx(0.3)


@pytest.mark.parametrize("calls", [2, 0])
def test_reader_finds_nothing_without_k8(calls):
    ops = [("void attngan::dfb::dfblock_kernel<__nv_bfloat16, true>(...)",
            0.0, 1e-3)] if calls else []
    assert harness.reader(METRIC)(_readings(ops, calls)) is None


def test_the_attngan_cells_report_it():
    bench = harness.benchmark_spec()
    for cell in ("lsun-serve-b64", "cub-serve-b1", "dfgan-serve-b64"):
        names = {m["name"] for m in harness.metrics_of(cell, bench)[
            "per_layer"]}
        assert (METRIC in names) == (cell != "dfgan-serve-b64"), cell
