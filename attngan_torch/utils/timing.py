"""Step timing, a profiler window and a profiler context for the training
loops, and a parameter count: port of attngan_tpu/utils/timing.py (the
port imports nothing of the JAX package).

``StepTimer`` and ``count_parameters`` as they are; ``StepWindowProfiler``
and ``profile_trace`` over torch.profiler instead of jax.profiler, writing
Chrome traces. The JAX module's ``block``, ``timer`` and ``device_timeit``
fence XLA's asynchronous dispatch through a remote device; they have no
counterpart: a CUDA timing here ends in ``torch.cuda.synchronize()`` or
reads CUDA events.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
