"""Step timing, a profiler window and a profiler context for the training
loops, a parameter count and two fenced timers: port of
attngan_tpu/utils/timing.py (the port imports nothing of the JAX package).

``StepTimer`` and ``count_parameters`` as they are; ``StepWindowProfiler``
and ``profile_trace`` over torch.profiler instead of jax.profiler, writing
Chrome traces. ``timer`` and ``device_timeit`` stop the clock only after
the device has finished the work, as JAX's block on their results: CUDA
launches return before the kernels run. The JAX module's ``block`` has no
counterpart: ``torch.cuda.synchronize()`` is the fence.

``span`` names a layer of the port in a torch.profiler trace; the JAX
module has no counterpart.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import time
from typing import Any, Callable, Optional

import torch


def _tensors(tree: Any):
    """The tensors of a result: a tensor, or lists, tuples and dicts of
    them, nested."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _synchronize(tree: Any) -> Any:
    """Wait until every CUDA device that holds a tensor of ``tree`` has
    finished its queued work; returns ``tree``."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


def timer(fn: Callable) -> Callable:
    """Wall-clock a host function, waiting for the devices of its tensor
    results (reference utilities/decorators.py:5-14)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        start = time.perf_counter()
        out = _synchronize(fn(*args, **kwargs))
        print(f"[timer] {fn.__name__}: {time.perf_counter() - start:.3f}s")
        return out

    return wrapped


def _first_element(out: Any) -> torch.Tensor:
    leaf = next(_tensors(out))
    return leaf[(0,) * leaf.dim()]


def device_timeit(fn: Callable, *args, iters: int = 20, warmup: int = 3,
                  fold: Optional[Callable[[Any], Any]] = None) -> float:
    """Seconds a call of ``fn(*args)``, over ``iters`` calls after
    ``warmup`` (the kernels' build and the allocator's warm-up untimed).

    Every call's output is folded into one scalar on its device (``fold``
    maps it to a scalar tensor; by default the first element of its first
    tensor), so the sum depends on every call. On a CUDA device the clock
    stops after one fence, ``torch.cuda.synchronize()`` after the last
    call, which waits for all queued work, and then one readback of the
    sum; on the CPU the calls have ended when they return. A non-finite
    sum raises."""
    fold = fold or _first_element
    for _ in range(warmup):
        _synchronize(fn(*args))
    acc = None
    start = time.perf_counter()
    for _ in range(iters):
        value = fold(fn(*args)).float()
        acc = value if acc is None else acc + value
    total = float(_synchronize(acc))
    elapsed = time.perf_counter() - start
    if not math.isfinite(total):
        raise RuntimeError(f"non-finite timing accumulator: {total}")
    return elapsed / iters


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records and nothing is being compiled, else one shared no-op context.

    The range lands in the profiler's trace beside the operators and the
    runtime calls it encloses, on the clock of the device's activities, so
    that a reader can divide the host's time between the port's layers.
    The guard is there because an unguarded ``record_function`` costs
    10-15 us a range even with no profiler running (torch 2.11 on an H100
    machine's host, 2.13 on a CPU), against 0.1 us for the check; and
    under ``torch.compile`` a range would enter the traced graph."""
    if (torch._C._autograd._profiler_enabled()
            and not torch.compiler.is_compiling()):
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _profiler():
    """A torch.profiler over the CPU, and the GPU where the process has one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Trace the block under torch.profiler into ``logdir/trace.json`` (a
    Chrome trace: chrome://tracing or Perfetto); a no-op when not
    ``enabled``."""
    if not enabled:
        yield
        return
    prof = _profiler()
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def count_parameters(module: torch.nn.Module, name: str = "model",
                     verbose: bool = True) -> int:
    """Total parameter count of ``module`` (reference trainer.py:27-31)."""
    total = sum(p.numel() for p in module.parameters())
    if verbose:
        print(f"Model {name} has {total} parameters")
    return total


class StepWindowProfiler:
    """Capture a torch.profiler trace of the 0-indexed steps [start, stop)
    of a train loop (``RunConfig.profile``) as a Chrome trace,
    ``logdir/trace.json`` (chrome://tracing or Perfetto). Skips the first
    steps so that kernel builds and warm-up are not in the trace. Call
    ``tick()`` once after EACH COMPLETED step and ``close()`` when the loop
    ends: after ``start`` ticks, steps 0..start-1 are done, the trace
    starts, and it stops at the ``stop``-th tick, covering steps
    start..stop-1. The GPU is traced when the process has one."""

    def __init__(self, logdir: str, enabled: bool = True, start: int = 2,
                 stop: int = 8):
        self.logdir = logdir
        self.enabled = enabled
        self.start = start
        self.stop = stop
        self._step = 0
        self._prof = None

    def tick(self) -> None:
        if not self.enabled:
            return
        self._step += 1
        if self._step == self.start:
            self._prof = _profiler()
            self._prof.__enter__()
        elif self._step == self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"[profile] wrote trace for steps "
              f"[{self.start}, {min(self._step, self.stop)}) to {path}")


class StepTimer:
    """Rolling steps/sec with an initial warmup skip (the first step builds
    the kernels and warms the allocator).

    ``tick(n)`` records one completed dispatch that performed ``n``
    optimization steps. Warmup is consumed per dispatch."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = -warmup
        self.start = None

    def tick(self, n: int = 1) -> None:
        if self.count < 0:
            self.count += 1
            if self.count == 0:
                self.start = time.perf_counter()
            return
        self.count += n

    @property
    def steps_per_sec(self) -> float:
        if self.count <= 0 or self.start is None:
            return 0.0
        return self.count / (time.perf_counter() - self.start)
