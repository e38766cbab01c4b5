"""The ``graph_replay.serve`` reader on hand-built traces, and on the tiny
traced CPU cell, where the port runs its generator eagerly."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.trace import Trace

from conftest import run_tiny, tiny


def call(t0: float, replay: bool) -> list:
    """One call's host ranges from ``t0``: a replay, or the eager
    generator's stages."""
    spans = [("attngan.serve", 0, 10), ("attngan.text_encoder", 0.5, 2),
             ("attngan.generator", 2, 9)]
    spans += ([("attngan.replay", 3, 4), ("cudaGraphLaunch", 3.1, 3.9)]
              if replay else [("attngan.stage1", 2.1, 5),
                              ("attngan.upblock", 3, 4)])
    return [(n, t0 + s, t0 + e) for n, s, e in spans]


def read(host_ops: list, calls: int):
    r = harness.Readings(Trace(40.0, calls, [], host_ops), None, 0.0, {})
    return harness.reader("graph_replay.serve")(r)


@pytest.mark.parametrize("replays, want", [
    ((True, True), 100.0), ((False, False), 0.0), ((True, False), 50.0)],
    ids=["every_call", "none", "one_of_two"])
def test_share_of_calls_that_replay(replays, want):
    ops = [op for k, rep in enumerate(replays) for op in call(20 * k, rep)]
    assert read(ops, len(replays)) == pytest.approx(want)


def test_a_replay_outside_the_calls_counts_for_nothing():
    ops = call(0, False) + call(20, False) + [("attngan.replay", 12, 13)]
    assert read(ops, 2) == 0.0


@pytest.mark.parametrize("host_ops, calls", [
    ([("attngan.replay", 0, 1), ("cudaGraphLaunch", 0.1, 0.9)], 1),
    (call(0, True), 2),
], ids=["no_serve_ranges", "fewer_serve_ranges_than_calls"])
def test_nothing_to_read(host_ops, calls):
    assert read(host_ops, calls) is None


def test_the_tiny_traced_cell_reads_no_replay_on_the_cpu():
    cell, cfg = tiny("cub-serve-b1", dtype="float32")
    out = run_tiny("cub-serve-b1", cell, cfg, trace=True)
    assert out["metrics"]["graph_replay.serve"]["value"] == 0.0
