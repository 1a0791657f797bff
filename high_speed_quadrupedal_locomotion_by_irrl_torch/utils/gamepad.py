"""Gamepad teleoperation input (reference: xbox360controller in
run_bp_v5.py:306-409 and the axis->command mapping of
GaitGenerator.update_gamepad, GaitGenerator.py:63-79). Port of
``utils/gamepad.py``.

Deployment boxes are often headless, so this reads the Linux joystick API
(/dev/input/jsN, struct js_event) directly with no third-party deps, and
takes a scripted command schedule when no device is present — the same
{vx, vy, wz} command interface either way.
"""

from __future__ import annotations

import os
import select
import struct
from typing import Sequence

import numpy as np

# Linux joystick API (linux/joystick.h)
_JS_EVENT_FMT = "IhBB"          # time(u32) value(s16) type(u8) number(u8)
_JS_EVENT_SIZE = struct.calcsize(_JS_EVENT_FMT)
_JS_EVENT_AXIS = 0x02

# xbox axis map used by the reference: left stick y -> vx (inverted),
# left stick x -> vy (inverted), right stick x -> wz (inverted)
_AXIS_VX, _AXIS_VY, _AXIS_WZ = 1, 0, 3


class Gamepad:
    """Non-blocking /dev/input/jsN reader returning [vx, vy, wz] in [-1, 1]."""

    def __init__(self, index: int = 0, device: str | None = None):
        self.path = device or f"/dev/input/js{index}"
        self._fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
        self._axes = np.zeros(8)

    @staticmethod
    def available(index: int = 0) -> bool:
        return os.path.exists(f"/dev/input/js{index}")

    def poll(self) -> np.ndarray:
        """Drain pending events; return [vx, vy, wz] normalized command."""
        while True:
            r, _, _ = select.select([self._fd], [], [], 0)
            if not r:
                break
            data = os.read(self._fd, _JS_EVENT_SIZE)
            if len(data) < _JS_EVENT_SIZE:
                break
            _, value, etype, number = struct.unpack(_JS_EVENT_FMT, data)
            if etype & _JS_EVENT_AXIS and number < self._axes.size:
                self._axes[number] = value / 32767.0
        return np.array([-self._axes[_AXIS_VX], -self._axes[_AXIS_VY],
                         -self._axes[_AXIS_WZ]])

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class ScriptedPad:
    """Headless stand-in: steps through (duration_s, [vx, vy, wz]) segments.

    Default schedule mirrors a typical teleop take: stand, accelerate
    forward, hold, turn, stop."""

    DEFAULT: Sequence[tuple[float, tuple[float, float, float]]] = (
        (1.0, (0.0, 0.0, 0.0)),
        (2.0, (0.4, 0.0, 0.0)),
        (3.0, (1.0, 0.0, 0.0)),
        (2.0, (1.0, 0.0, 0.3)),
        (2.0, (0.3, 0.0, 0.0)),
        (1.0, (0.0, 0.0, 0.0)),
    )

    def __init__(self, schedule=None, dt: float = 0.002):
        self.schedule = list(schedule or self.DEFAULT)
        self.dt = dt
        self._t = 0.0

    def poll(self) -> np.ndarray:
        t = self._t
        self._t += self.dt
        for dur, cmd in self.schedule:
            if t < dur:
                return np.asarray(cmd, dtype=np.float64)
            t -= dur
        return np.asarray(self.schedule[-1][1], dtype=np.float64)

    def close(self) -> None:
        pass


def open_pad(index: int = 0, schedule=None, dt: float = 0.002):
    """Gamepad if a joystick device exists, else the scripted fallback."""
    if Gamepad.available(index):
        try:
            return Gamepad(index)
        except OSError:
            pass
    return ScriptedPad(schedule, dt)
