"""The reader of K9's per-layer metric, ``bilstm_ms.serve``, by hand: the
summed device time of the kernels whose name holds ``bilstm``, per traced
call, and None where none ran (cuDNN's packed RNN, K9's parent)."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.trace import Trace

METRIC = "bilstm_ms.serve"
CELLS = ("lsun-serve-b64", "cub-serve-b1", "dfgan-serve-b64")


def _readings(ops, calls=2):
    return harness.Readings(Trace(1.0, calls, ops, []), None, 0.0, {})


def test_reader_of_k9_by_hand():
    ops = [("void attngan::bilstm::bilstm_kernel<4>(float const*, ...)",
            0.0, 2e-5),
           ("void attngan::bilstm::bilstm_kernel<1>(float const*, ...)",
            1e-3, 1.06e-3),
           ("void at::native::(anonymous namespace)::indexSelectLargeIndex",
            2e-3, 2.1e-3),
           ("Memcpy HtoD (Pinned -> Device)", 3e-3, 3.2e-3)]
    assert harness.reader(METRIC)(_readings(ops)) == pytest.approx(0.04)


@pytest.mark.parametrize("calls", [2, 0])
def test_reader_finds_nothing_without_k9(calls):
    # the parent's text encoder: cuDNN's per-step RNN kernels
    ops = [("void elemWiseRNNcell<float, float, float, 0, 2>(...)", 0.0, 1e-5),
           ("void gemvx::kernel<int, int, float, float, float>(...)", 1e-4,
            2e-4)] if calls else []
    assert harness.reader(METRIC)(_readings(ops, calls)) is None


def test_every_serving_cell_reports_it():
    bench = harness.benchmark_spec()
    for cell in CELLS:
        names = {m["name"] for m in harness.metrics_of(cell, bench)[
            "per_layer"]}
        assert METRIC in names, cell
    entry = [m for m in bench["per_layer"] if m["name"] == METRIC][0]
    assert entry["layer"] == "text encoder"
    assert entry["moves"] == "serve_img_per_s"
