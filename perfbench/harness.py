"""One run of one cell: set-up, the measured window, the traced sub-window,
the check, and the result line.

Everything a cell is comes from data found by name: its workload file
(``workloads/<cell>.json``: entry, traced calls, check), its traffic mix
(``mixes/<traffic>.json``), the configuration (``configs/<config>.json``),
the driver of its entry (``drivers/<entry>.py``) and a reader per
per-layer metric (``metrics/<metric>.py``). ``BENCHMARK.json`` at the checkout's root names
each cell's configuration and traffic, and which metrics it reports.

The window: a closed loop calls back to back from one client until the
window's seconds are spent, then synchronizes; its rate is the rows of
every call over the whole time. Where the mix is ``synchronous``, each
call ends in a synchronize before the next starts, and each call's time,
from its start to its outputs complete on the device, is kept for the
tail.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, benchmark: dict) -> dict:
    """The cell's entry of ``benchmark`` (config, traffic, chips, why), its
    workload file (entry, traced_calls, check) and its traffic mix's
    parameters under ``"mix"``."""
    entry = [w for w in benchmark["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(entry[0])
    cell.update(load_json(os.path.join(HERE, "workloads", f"{name}.json")))
    cell["mix"] = load_json(os.path.join(HERE, "mixes",
                                         f"{cell['traffic']}.json"))
    return cell


def benchmark_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def config_spec(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(entry: str):
    return _module(os.path.join(HERE, "drivers", f"{entry}.py"),
                   f"perfbench.drivers.{entry}").Driver


def reader(metric: str):
    return _module(os.path.join(HERE, "metrics", f"{metric}.py"),
                   f"perfbench_metric_{metric}").read


def metrics_of(cell: str, benchmark: dict) -> Dict[str, List[dict]]:
    """{"end_to_end": [...], "per_layer": [...]}: the entries of
    ``benchmark`` that ``cell`` reports."""
    def ours(m):
        return "workloads" not in m or cell in m["workloads"]
    return {k: [m for m in benchmark[k] if ours(m)]
            for k in ("end_to_end", "per_layer")}


def process_start() -> float:
    """The epoch time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def quantile(values: List[float], q: float) -> float:
    """The q-quantile, linear between order statistics."""
    v = sorted(values)
    x = q * (len(v) - 1)
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


@dataclass
class Window:
    seconds: float
    calls: int
    rows: int
    call_s: List[float] = field(default_factory=list)   # synchronous mixes

    @property
    def seconds_per_call(self) -> float:
        return self.seconds / max(self.calls, 1)


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_of(drv, cell: dict, device):
    """The window's call: the driver's, followed by a synchronize where
    the mix is synchronous."""
    if not cell["mix"].get("synchronous"):
        return drv.call

    def call(i: int) -> None:
        drv.call(i)
        synchronize(device)
    return call


def closed_loop(drv, cell: dict, seconds: float, device) -> Window:
    """Calls back to back until ``seconds`` are spent, then a
    synchronize; a synchronous mix's calls are timed one by one."""
    step = step_of(drv, cell, device)
    timed = bool(cell["mix"].get("synchronous"))
    n, call_s = 0, []
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        start = time.perf_counter()
        if start >= end:
            break
        step(n)
        if timed:
            call_s.append(time.perf_counter() - start)
        n += 1
    synchronize(device)
    return Window(time.perf_counter() - t0, n, drv.rows, call_s)


def end_to_end(window: Window) -> Dict[str, float]:
    """Every end-to-end quantity a window can give; the cell's entries of
    BENCHMARK.json pick theirs."""
    out = {"serve_img_per_s": window.calls * window.rows / window.seconds}
    if window.call_s:
        out["serve_call_ms_p95"] = 1e3 * quantile(window.call_s, 0.95)
    return out


@dataclass
class Readings:
    """What the per-layer readers read."""
    trace: object
    window: Window
    flops_per_call: float
    bounds_per_call: Dict[str, float]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             benchmark: Optional[dict] = None,
             started: Optional[float] = None) -> dict:
    """One run of the cell ``name`` of ``benchmark`` (BENCHMARK.json)."""
    started = process_start() if started is None else started
    benchmark = benchmark or benchmark_spec()
    cell = cell_spec(name, benchmark)
    return run(cell, config_spec(cell["config"]), seed, seconds, trace,
               device, metrics_of(name, benchmark), started=started)


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device, wanted: Dict[str, List[dict]], variant: str = "program",
        started: Optional[float] = None) -> dict:
    """The result line's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, and ``breakdown`` where traced), and
    ``compared``: the numbers the check compared with their limits."""
    started = time.time() if started is None else started
    drv = driver_class(cell["entry"])(cell, cfg, seed, device, variant)
    synchronize(device)
    setup_s = time.time() - started
    if device.type == "cuda":
        # the peak of the program's window, not of the reference's
        # calibration in set-up
        torch.cuda.reset_peak_memory_stats(device)

    if trace:
        window = closed_loop(drv, cell, seconds / 2, device)
        step, first = step_of(drv, cell, device), window.calls
        traced = _profile(lambda k: step(first + k), cell["traced_calls"],
                          device)
    else:
        window = closed_loop(drv, cell, seconds, device)
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    readings = None
    if trace:
        readings = Readings(traced, window, drv.flops_per_call(),
                            drv.bounds_per_call())
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = drv.check()
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in compared)

    metrics = {}
    if trace:
        for m in wanted["per_layer"]:
            value = reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(window)
        e2e["setup_s"] = setup_s
        for m in wanted["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out = {"correct": correct, "attempted": window.calls,
           "failed": 0, "metrics": metrics,
           "device": device_fields(device, memory)}
    if trace:
        out["device"]["busy_s"] = traced.busy_s()
        out["device"]["window_s"] = traced.window_s
        out["breakdown"] = traced.breakdown()
    out["compared"] = compared
    return out


def _profile(run, calls: int, device):
    from perfbench.trace import profile_calls

    return profile_calls(run, calls, lambda: synchronize(device))


def device_fields(device, memory: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory)}
