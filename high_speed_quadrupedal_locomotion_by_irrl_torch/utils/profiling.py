"""Host spans and counters on the profiler's clock, and the trace export.

Port of ``utils/profiling.py``. The reference's only profiler hook is TF
RunMetadata FULL_TRACE every 10th update (ppo2.py:277-287); here the
``torch.profiler`` window is the switch.

``span(name)`` names a stretch of host work, as a ``with`` block or as a
decorator. While a ``torch.profiler`` window is open, or inside
:func:`recording`, each span records ``(name, parent, step, t0_ns, t1_ns)``:
``parent`` is the index of the enclosing span (-1 at the top), ``step`` the
control-step index the loop set with :func:`set_step` (the identifier the
spans of one step share), and the times are Unix-epoch nanoseconds, the clock
on which the profiler reports its host and device events, so a gap in the
device's activity lies on one line with the host span that was open during it.
The profiler stamps its events on a raw hardware clock and maps them to the
wall clock by a straight line over its window; so do the spans: each is stamped
on ``CLOCK_MONOTONIC_RAW`` and mapped, when taken, by the line through the wall
clock at the recording's first and last span. (Stamped with the wall clock
itself they would move against the device's events wherever the system
corrects the wall clock during the window.) ``count(name, n)`` records a
counter beside the spans, with the current step and the innermost open span.
The records stay in memory until :func:`take` hands them over.

Outside a window a span is one flag check: it issues no PyTorch op, does
not synchronize and allocates nothing. Under :func:`trace`, the operator's
Chrome-trace export, each span is also a ``record_function``, a host row over
the kernels of ``trace.json``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    parent: int            # index of the enclosing span in the recording, -1 at the top
    step: Optional[int]    # the control step set by set_step when the span opened
    t0_ns: int             # Unix-epoch ns at its start and end, on the profiler's line
    t1_ns: Optional[int]   # None while it is still open


class Count(NamedTuple):
    name: str
    span: int              # index of the innermost open span, -1 if none
    step: Optional[int]
    n: int


class Recording(NamedTuple):
    spans: list            # of Span, in the order they opened
    counts: list           # of Count


_forced = 0        # depth of recording() blocks
_emit = 0          # depth of trace() blocks: spans are record_functions as well
_step: Optional[int] = None
_spans: list = []  # [name, parent, step, t0, t1, own index] each
_counts: list = []
_open: list = []   # (span object, its record, its record_function or None)
_fit: list = []    # raw and wall clock at the first span's start and the last span's end

_raw = time.clock_gettime_ns
_RAW = getattr(time, "CLOCK_MONOTONIC_RAW", time.CLOCK_MONOTONIC)


class _Span(contextlib.ContextDecorator):
    """One name's span; :func:`span` hands out one object a name, re-entered
    at every call (the open spans live on a module stack)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _forced or _profiler._is_profiler_enabled:
            rec = [self.name, _open[-1][1][5] if _open else -1, _step, 0, None, len(_spans)]
            _spans.append(rec)
            rf = None
            if _emit:
                rf = _profiler.record_function(self.name)
                rf.__enter__()
            rec[3] = _raw(_RAW)
            if not _fit:
                _fit.extend((rec[3], time.time_ns(), rec[3], 0))
            _open.append((self, rec, rf))
        return self

    def __exit__(self, *exc):
        if _open and _open[-1][0] is self:
            _, rec, rf = _open.pop()
            rec[4] = _fit[2] = _raw(_RAW)
            _fit[3] = time.time_ns()
            if rf is not None:
                rf.__exit__(None, None, None)
        return False


_SPANS: dict = {}


def span(name: str) -> _Span:
    """The span named ``name``: ``with span(name): ...`` or ``@span(name)``."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name)
    return s


def set_step(step: Optional[int]) -> None:
    """The control step the spans and counters opened from now on belong to
    (None outside a loop over steps)."""
    global _step
    _step = step


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` at the current step, while recording."""
    if _forced or _profiler._is_profiler_enabled:
        _counts.append((name, _open[-1][1][5] if _open else -1, _step, n))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Records spans and counters without a profiler window (tests, tools)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def take() -> Recording:
    """The spans and counters recorded so far, handed over and cleared; a span
    still open is handed over with ``t1_ns`` None and its end is not recorded."""
    global _spans, _counts
    spans, counts = _spans, _counts
    _spans, _counts = [], []
    del _open[:]
    raw0, wall0, raw1, wall1 = _fit or (0, 0, 0, 0)
    del _fit[:]
    # the wall clock's line through the first and the last span (slope 1 over a short one)
    slope = (wall1 - wall0) / (raw1 - raw0) if raw1 - raw0 > 10_000_000 and wall1 else 1.0

    def wall(t):
        return None if t is None else wall0 + round((t - raw0) * slope)
    return Recording([Span(r[0], r[1], r[2], wall(r[3]), wall(r[4])) for r in spans],
                     [Count(*c) for c in counts])


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the host and, where there is one, the
    card, the spans as host rows; written as ``trace.json`` (Chrome trace
    format) under ``log_dir``. Yields the profiler; the spans' records are left
    for :func:`take`."""
    global _emit
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        _emit += 1
        try:
            yield prof
        finally:
            _emit -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
