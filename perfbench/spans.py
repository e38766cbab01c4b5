"""The port's own spans in the traced sub-window, for the ``host_*``
readers of ``metrics/``.

``attngan_torch.utils.timing.span`` opens a ``record_function`` range at
each layer boundary of serving while a profiler records: ``attngan.serve``
(one a call) holds ``attngan.text_encoder`` and ``attngan.generator``, and
the generator's stages hold the ``attngan.upblock`` ranges. They reach
``Trace.host_ops`` beside the host's operators and CUDA runtime calls, on
the clock of the device's activities. One host thread serves, so a span's
call is the ``attngan.serve`` range its start lies in.

Each reader returns None where the traced calls opened no
``attngan.serve``, or a number of them other than the calls traced (a
program without the spans, or a trace that lost some).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

SERVE = "attngan.serve"
TEXT_ENCODER = "attngan.text_encoder"
GENERATOR = "attngan.generator"
UPBLOCK = "attngan.upblock"

# runtime calls that return only once the device has caught up: the
# synchronous cudaMemcpy, not cudaMemcpyAsync
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy"})

Interval = Tuple[float, float]


def named(trace, name: str) -> List[Interval]:
    """(start, end) of the host ranges called ``name``, in start order."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == name)


def served(trace) -> Optional[List[Interval]]:
    """The ``attngan.serve`` ranges, one a traced call, or None."""
    calls = named(trace, SERVE)
    if not calls or len(calls) != trace.calls:
        return None
    return calls


def inside(spans: Sequence[Interval], outer: Sequence[Interval]
           ) -> List[Interval]:
    """The spans whose start lies in one of ``outer``'s ranges (sorted,
    disjoint)."""
    starts = [s for s, _ in outer]
    out = []
    for s, e in spans:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and s <= outer[k][1]:
            out.append((s, e))
    return out


def union_s(spans: Sequence[Interval]) -> float:
    """Seconds covered by at least one of ``spans``."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def per_call_ms(trace, seconds: float) -> float:
    return 1e3 * seconds / trace.calls


def host_ms(r, name: str) -> Optional[float]:
    """Host milliseconds a call spent inside the ``name`` ranges of the
    traced calls (their union: the sum, where they do not nest)."""
    calls = served(r.trace)
    if calls is None:
        return None
    return per_call_ms(r.trace, union_s(inside(named(r.trace, name), calls)))


def generator_self_ms(r) -> Optional[float]:
    """Host milliseconds a call inside ``attngan.generator`` and outside
    every ``attngan.upblock`` range within it."""
    calls = served(r.trace)
    if calls is None:
        return None
    generators = inside(named(r.trace, GENERATOR), calls)
    blocks = named(r.trace, UPBLOCK)
    own = 0.0
    for s, e in generators:
        within = [(max(a, s), min(b, e)) for a, b in blocks
                  if a < e and b > s]
        own += (e - s) - union_s(within)
    return per_call_ms(r.trace, own)


def blocking_calls(r) -> Optional[List[Interval]]:
    """The blocking runtime calls that start inside a traced call."""
    calls = served(r.trace)
    if calls is None:
        return None
    ops = sorted((s, e) for n, s, e in r.trace.host_ops if n in BLOCKING)
    return inside(ops, calls)


def syncs_per_call(r) -> Optional[float]:
    found = blocking_calls(r)
    return None if found is None else len(found) / r.trace.calls


def wait_ms(r) -> Optional[float]:
    found = blocking_calls(r)
    if found is None:
        return None
    return per_call_ms(r.trace, sum(e - s for s, e in found))
