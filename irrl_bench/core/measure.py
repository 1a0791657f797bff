"""Clocks, the profiler's raw device events, op counts and call recorders.

Frozen copies of the measurement pieces the repository's ``chip_smoke.py``
uses (``device_events``, ``OpCounter``, ``_SyncedTimers``), so that the
benchmark's yardstick does not move when that script does.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def now() -> float:
    """Host time once the device has finished what was queued."""
    sync()
    return time.perf_counter()


# --- wrapping module functions -----------------------------------------------

class Patch:
    """Replaces ``module.attr`` by ``make(original)`` while the ``with`` block
    runs; callers that look the attribute up at call time see the wrapper."""

    def __init__(self, module, attr: str, make: Callable):
        self.module, self.attr, self.make = module, attr, make

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self.make(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


class SyncedTimers:
    """Wall seconds and calls of each function of ``sites`` (name -> (module,
    attribute)), the device synchronized around each call, while the ``with``
    block runs."""

    def __init__(self, sites: dict):
        self.sites = sites
        self.seconds = dict.fromkeys(sites, 0.0)
        self.calls = dict.fromkeys(sites, 0)
        self._patches = []

    def _timed(self, key):
        def make(fn):
            def run(*a, **kw):
                t0 = now()
                try:
                    return fn(*a, **kw)
                finally:
                    self.seconds[key] += now() - t0
                    self.calls[key] += 1
            return run
        return make

    def __enter__(self):
        self._patches = [Patch(mod, attr, self._timed(k)) for k, (mod, attr) in self.sites.items()]
        for p in self._patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.__exit__(*exc)


class Recorder:
    """Keeps, for the calls of ``module.attr`` whose running index is in
    ``picks``, what ``keep(args, kwargs, result)`` returns (cloned tensors)."""

    def __init__(self, module, attr: str, picks, keep: Callable):
        self.picks, self.keep = set(picks), keep
        self.kept: dict[int, object] = {}
        self.count = 0
        self._patch = Patch(module, attr, self._make)

    def _make(self, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if self.count in self.picks:
                self.kept[self.count] = self.keep(a, kw, out)
            self.count += 1
            return out
        return run

    def __enter__(self):
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


# --- op counts ----------------------------------------------------------------

class OpCounter(TorchDispatchMode):
    """``calls``: every PyTorch (aten) op issued, views included."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def count_calls(fn: Callable) -> int:
    with OpCounter() as c:
        fn()
    return c.calls


# --- the profiler --------------------------------------------------------------

def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device event of a finished
    torch.profiler window, read from its raw results: ``prof.events()`` builds
    Python objects and a tree over every event first, minutes on large
    windows."""
    hidden = lambda e: getattr(e, "is_hidden_event", lambda: False)()  # noqa: E731
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not hidden(e)]


def busy_union_ns(events) -> int:
    """Nanoseconds in which at least one device event ran."""
    total, end = 0, None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def breakdown(events, top: int = 10) -> dict:
    """The device ops that took most time (summed by name) and the idle gaps
    between device events, summed by the op the device waited for."""
    by_name: dict[str, float] = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    gaps: dict[str, float] = {}
    end = None
    for name, s, e in sorted(events, key=lambda x: x[1]):
        if end is not None and s > end:
            key = "before " + name
            gaps[key] = gaps.get(key, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)

    def pick(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(by_name), "idle_gaps": pick(gaps)}


def profile(fn: Callable) -> dict:
    """Runs ``fn`` under torch.profiler (device activity only) and returns its
    device events, the window's host seconds and the busy union."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = now()
        fn()
        window = now() - t0
    events = device_events(prof)
    return {"events": events, "window_s": window, "busy_s": busy_union_ns(events) / 1e9}
