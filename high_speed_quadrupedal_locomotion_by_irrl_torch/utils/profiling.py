"""Profiling & throughput instrumentation.

Port of ``utils/profiling.py``. The reference's only profiler hook is TF
RunMetadata FULL_TRACE every 10th update (ppo2.py:277-287) plus an fps counter
(:407-408). Here: ``torch.profiler`` traces on demand and a tiny rate meter.
The JAX package's ``enable_compile_cache`` has no counterpart: PyTorch runs
eagerly and the CUDA kernels are cached by ``ops/_build.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the host and, where there is one, the
    card; written as ``trace.json`` (Chrome trace format) under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RateMeter:
    """steps/s / solves/s counter with exponential smoothing."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._t = time.perf_counter()

    def tick(self, units: float) -> float:
        now = time.perf_counter()
        dt = max(now - self._t, 1e-9)
        self._t = now
        inst = units / dt
        self.rate = inst if self.rate is None else (
            self.alpha * inst + (1 - self.alpha) * self.rate)
        return self.rate


@contextlib.contextmanager
def timed(label: str, sink=None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink(label, dt)
    else:
        print(f"[timing] {label}: {dt * 1e3:.2f} ms")
