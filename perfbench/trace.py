"""The traced sub-window: ``torch.profiler`` (CUPTI) over a few calls,
reduced in memory to what the per-layer readers and ``breakdown`` need.

``Trace`` holds the device operations (kernels, copies, sets; not the
``record_function`` ranges that the profiler also draws on the device's
timeline) as (name, start, end) in seconds, and the host's operator
spans. Nothing is written to disk.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

Span = Tuple[str, float, float]


@dataclass
class Trace:
    window_s: float
    calls: int
    device_ops: List[Span] = field(default_factory=list)
    host_ops: List[Span] = field(default_factory=list)

    def kernels(self, pattern: str = "") -> List[Span]:
        """Device kernels (not copies or sets) whose name holds
        ``pattern``."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))
                and pattern in op[0]]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        their intervals."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside the window, longest first."""
        out, end = [], None
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return sorted(out, key=lambda g: g[0] - g[1])

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for s, e in self.gaps()[:top]:
            gaps.append([self.host_at(0.5 * (s + e)), e - s])
        return {"device_ops": [[short(n), t] for n, t in ops],
                "idle_gaps": gaps}

    def host_at(self, t: float) -> str:
        """The innermost host operator running at ``t``."""
        inner = None
        for name, s, e in self.host_ops:
            if s <= t <= e and (inner is None or e - s < inner[2] - inner[1]):
                inner = (name, s, e)
        return "(no host operator)" if inner is None else inner[0]


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its template arguments' bulk."""
    return name if len(name) <= limit else name[:limit] + "..."


def profile_calls(run, calls: int, synchronize) -> Trace:
    """Run ``run(k)`` for k < calls under the profiler, end with
    ``synchronize()``, and reduce."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for k in range(calls):
            run(k)
        synchronize()
        window = time.perf_counter() - t0
    trace = Trace(window, calls)
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        span = (ev.name(), start, start + ev.duration_ns() * 1e-9)
        if ev.device_type() != cuda:
            trace.host_ops.append(span)
        elif not _annotation(ev):
            trace.device_ops.append(span)
    return trace


def _annotation(ev) -> bool:
    """A ``record_function`` range drawn on the device's timeline: it spans
    the kernels it encloses and the gaps between them, and is no
    operation."""
    if hasattr(ev, "is_user_annotation"):
        return bool(ev.is_user_annotation())
    return "annotation" in str(getattr(ev, "activity_type", lambda: "")())
