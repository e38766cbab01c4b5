"""The ``host_*`` readers (``perfbench/spans.py``) on hand-built traces,
and on the tiny traced CPU cell, where the port opens its spans."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.trace import Trace

from conftest import run_tiny, tiny

HOST_METRICS = ("host_ms.serve", "host_ms.text_encoder", "host_ms.generator",
                "host_ms.upblock", "host_syncs.serve", "host_wait_ms.serve")


def one_call(t0: float) -> list:
    """One call's host ranges, in seconds from ``t0``: the generator (2-9)
    holds UpBlocks that overlap (3-4, 3.5-5), nest (6.2-6.5 in 6-7) and
    run past its end (8.5-9.5); two blocking calls and an asynchronous
    copy."""
    spans = [("attngan.serve", 0, 10), ("attngan.text_encoder", 0.5, 2),
             ("aten::lstm", 0.6, 1.9), ("attngan.generator", 2, 9),
             ("attngan.upblock", 3, 4), ("attngan.upblock", 3.5, 5),
             ("attngan.upblock", 6, 7), ("attngan.upblock", 6.2, 6.5),
             ("attngan.upblock", 8.5, 9.5),
             ("cudaMemcpyAsync", 0.8, 0.9), ("cudaStreamSynchronize", 0.9, 1.5),
             ("cudaMemcpy", 8.0, 8.25), ("cudaLaunchKernel", 8.3, 8.4)]
    return [(n, t0 + s, t0 + e) for n, s, e in spans]


def readings(host_ops: list, calls: int) -> harness.Readings:
    return harness.Readings(Trace(40.0, calls, [], host_ops), None, 0.0, {})


def read(metric: str, r):
    return harness.reader(metric)(r)


TWO_CALLS = (one_call(0) + one_call(20)
             + [("cudaDeviceSynchronize", 15, 16),      # between calls
                ("attngan.upblock", 12, 13)])


def test_host_milliseconds_by_layer():
    r = readings(TWO_CALLS, 2)
    assert read("host_ms.serve", r) == pytest.approx(10e3)
    assert read("host_ms.text_encoder", r) == pytest.approx(1.5e3)
    # 7 s less the UpBlocks' union inside the generator: 3-5, 6-7, 8.5-9
    assert read("host_ms.generator", r) == pytest.approx(3.5e3)
    # the UpBlocks' union inside the calls: 3-5, 6-7, 8.5-9.5
    assert read("host_ms.upblock", r) == pytest.approx(4e3)


def test_the_layers_fit_inside_the_call():
    r = readings(TWO_CALLS, 2)
    parts = sum(read(m, r) for m in ("host_ms.text_encoder",
                                     "host_ms.generator", "host_ms.upblock"))
    assert parts <= read("host_ms.serve", r)


def test_blocking_calls_inside_the_calls_only():
    r = readings(TWO_CALLS, 2)
    # cudaStreamSynchronize and the synchronous cudaMemcpy; not the
    # asynchronous copy, not the launch, not the synchronize between calls
    assert read("host_syncs.serve", r) == 2.0
    assert read("host_wait_ms.serve", r) == pytest.approx(0.85e3)


@pytest.mark.parametrize("host_ops, calls", [
    ([("aten::mul", 0, 1), ("cudaStreamSynchronize", 1, 2)], 2),
    (TWO_CALLS, 3),
    (one_call(0), 2),
], ids=["no_spans", "fewer_spans_than_calls", "one_of_two"])
@pytest.mark.parametrize("metric", HOST_METRICS)
def test_nothing_to_read(metric, host_ops, calls):
    assert read(metric, readings(host_ops, calls)) is None


def test_the_tiny_traced_cell_reports_all_six():
    cell, cfg = tiny("lsun-serve-b64", dtype="float32")
    out = run_tiny("lsun-serve-b64", cell, cfg, trace=True)
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(HOST_METRICS) <= set(metrics)
    assert metrics["host_syncs.serve"] == 0           # no CUDA on the CPU
    assert metrics["host_wait_ms.serve"] == 0
    assert all(metrics[m] > 0 for m in HOST_METRICS[:4])
    assert (metrics["host_ms.text_encoder"] + metrics["host_ms.generator"]
            + metrics["host_ms.upblock"] <= metrics["host_ms.serve"])
