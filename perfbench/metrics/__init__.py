"""Per-layer readers, one file per metric of BENCHMARK.json: ``read(r)``
takes the traced run's ``harness.Readings`` and returns the metric, or
None where there is nothing to read. The arithmetic they share is here."""

from __future__ import annotations

from typing import Optional

from perfbench.counts import PEAK_BF16_FLOPS


def launches(r) -> Optional[float]:
    """Device kernels a call in the profiled sub-window."""
    n = len(r.trace.kernels())
    return n / r.trace.calls if n and r.trace.calls else None


def mfu_percent(r) -> Optional[float]:
    """The reference's FLOPs a call over the unprofiled sub-window's wall
    time a call, as a share of the chip's bf16 peak."""
    if not r.flops_per_call or not r.window.calls:
        return None
    return 100.0 * r.flops_per_call / r.window.seconds_per_call / PEAK_BF16_FLOPS


def idle_percent(r) -> Optional[float]:
    """The share of the profiled sub-window in which the device ran
    nothing."""
    if r.trace.window_s <= 0 or not r.trace.device_ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)


def roofline_percent(r, family: str, pattern: str) -> Optional[float]:
    """Sum of a kernel family's bounds over its summed device time."""
    ops = r.trace.kernels(pattern)
    spent = sum(e - s for _, s, e in ops)
    bound = r.bounds_per_call.get(family)
    if not ops or spent <= 0 or not bound:
        return None
    return 100.0 * bound * r.trace.calls / spent
