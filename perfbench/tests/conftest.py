"""Shared helpers of the benchmark's CPU tests: the cells at a size a CPU
test run holds (the configurations' widths cut, the traffic's rows and
pool cut), run through the harness with the device set to the CPU."""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

TINY = {"gf_dim": 4, "df_dim": 4, "emb_dim": 16, "vocab": 50}
CPU = torch.device("cpu")
def tiny(name: str, rows: int = 2, pool: int = 4, dtype: str = "",
         **check) -> tuple:
    """(cell, configuration) of BENCHMARK.json's cell ``name`` cut to a
    CPU test's size; ``check`` overrides limits."""
    cell = harness.cell_spec(name, harness.benchmark_spec())
    cfg = dict(harness.config_spec(cell["config"]))
    cfg.update(TINY, seq_len=min(cfg["seq_len"], 6))
    if dtype:
        cfg["compute_dtype"] = dtype
    words = cell["mix"]["words"]
    cell["mix"] = dict(cell["mix"], rows=rows, pool=pool,
                       words=[min(words[0], 2), min(words[1], 6)])
    cell["check"] = dict(cell["check"], **check)
    if "sample" in cell["check"]:
        cell["check"]["sample"] = min(cell["check"]["sample"], 2)
    cell["traced_calls"] = 2
    return cell, cfg


class Ticks:
    """A clock for the window that moves 50 ms a reading, so that a tiny
    window makes the same calls however loaded the test machine is."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.05
        return self.now

    time = staticmethod(time.time)


def run_tiny(name: str, cell: dict, cfg: dict, seed: int = 2**33 + 5,
             trace: bool = False, variant: str = "program",
             seconds: float = 1.0) -> dict:
    bench = harness.benchmark_spec()
    real, harness.time = harness.time, Ticks()
    try:
        return harness.run(cell, cfg, seed, seconds, trace, CPU,
                           harness.metrics_of(name, bench), variant)
    finally:
        harness.time = real


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    yield
    torch.set_num_threads(before)
