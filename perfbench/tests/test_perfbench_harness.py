"""The harness as data: BENCHMARK.json against the files it names, the
traffic against its seed, and the refusal to measure without a card."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench import traffic as tr

from conftest import CPU, ROOT

BENCH = harness.benchmark_spec()
HERE = os.path.join(ROOT, "perfbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_names_files_that_exist(cell):
    spec = harness.cell_spec(cell["name"], BENCH)
    cfg = harness.config_spec(cell["config"])
    assert cfg["name"] == cell["config"]
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       f"{spec['entry']}.py"))
    assert hasattr(harness.driver_class(spec["entry"]), "check")
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    config = [c for c in BENCH["configs"] if c["name"] == cell["config"]][0]
    assert os.path.exists(os.path.join(ROOT, config["file"]))
    assert config["reduced"] == cfg["reduced"]
    wanted = harness.metrics_of(cell["name"], BENCH)
    names = {m["name"] for m in wanted["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert wanted["per_layer"]
    # every limit is set: a cell whose check has no limit is never correct
    assert all(v is not None for v in spec["check"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader_and_cells(metric):
    assert callable(harness.reader(metric["name"]))
    moves = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moves
    for cell in metric["workloads"]:
        assert cell in {w["name"] for w in BENCH["workloads"]}
        assert cell in moves[0].get("workloads", [cell])


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                            for w in BENCH["workloads"]}))
def test_one_seed_gives_the_same_traffic(traffic):
    mix = harness.load_json(os.path.join(HERE, "mixes", f"{traffic}.json"))
    mix = dict(mix, rows=min(mix["rows"], 3), pool=min(mix["pool"], 3))
    cfg = {"seq_len": 18, "vocab": 50, "z_dim": 4, "cond_dim": 3}
    big = 2**31 + 12345
    a, b = (tr.make_pool(mix, cfg, big, CPU) for _ in range(2))
    c = tr.make_pool(mix, cfg, big + 1, CPU)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["noise"], c["noise"])
    # another seed reorders the lengths, it does not change their set
    assert sorted(a["lengths"].flatten().tolist()) == sorted(
        c["lengths"].flatten().tolist())
    lo, hi = mix["words"]
    assert int(a["lengths"].min()) >= lo and int(a["lengths"].max()) <= hi
    pad = torch.arange(18) >= a["lengths"][..., None]
    assert not bool(a["tokens"][pad].any())


class _Sleeper:
    rows = 3

    def __init__(self):
        self.calls = []

    def call(self, i):
        self.calls.append(i)
        time.sleep(0.002)


@pytest.mark.parametrize("synchronous", [False, True])
def test_closed_loop_counts_every_call(synchronous):
    """Calls run back to back, numbered from 0; a synchronous mix times
    each of them, and its tail is the p95 of those times."""
    drv = _Sleeper()
    cell = {"mix": {"synchronous": True} if synchronous else {}}
    w = harness.closed_loop(drv, cell, 0.2, CPU)
    assert drv.calls == list(range(w.calls)) and w.calls > 10
    assert w.seconds >= 0.2 and w.rows == 3
    assert len(w.call_s) == (w.calls if synchronous else 0)
    e2e = harness.end_to_end(w)
    assert e2e["serve_img_per_s"] == pytest.approx(3 * w.calls / w.seconds)
    assert ("serve_call_ms_p95" in e2e) == synchronous
    if synchronous:
        assert 2.0 <= e2e["serve_call_ms_p95"] < 1e3 * w.seconds


def test_quantile():
    assert harness.quantile([4, 1, 3, 2, 5], 0.5) == 3
    assert harness.quantile(list(range(101)), 0.95) == 95


def _run(cwd: str, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "lsun-serve-b64",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    """The measuring path refuses the CPU: exit 1, no result line."""
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_port_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_on_the_cpu_has_the_contract_keys():
    from conftest import run_tiny, tiny

    cell, cfg = tiny("lsun-serve-b64", dtype="float32")
    out = run_tiny("lsun-serve-b64", cell, cfg)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {"serve_img_per_s", "setup_s"}
    json.dumps(out)
    traced = run_tiny("lsun-serve-b64", cell, cfg, trace=True)
    assert set(traced["metrics"]) <= {m["name"] for m in BENCH["per_layer"]}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
