"""Step timing and a profiler window for the training loops.

Port of the framework-free part of attngan_tpu/utils/timing.py (the port
imports nothing of the JAX package): ``StepTimer`` as is, and
``StepWindowProfiler`` over torch.profiler instead of jax.profiler. The
JAX module's ``block``, ``timer`` and ``device_timeit`` fence XLA's
asynchronous dispatch and have no counterpart here.
"""

from __future__ import annotations

import os
import time

import torch


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
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
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
