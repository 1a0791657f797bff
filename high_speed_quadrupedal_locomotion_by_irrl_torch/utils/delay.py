"""Latency-injection tool (capability parity with IRRL/script/utils/DelayTool.py).

The reference emulates sensor/actuation latency with a FIFO of
``delay_time/dt`` slots (DelayTool.py:5-23). Port of ``utils/delay.py``: the
FIFO is a fixed-size ring buffer of tensors, returned anew by every push as
the JAX package's is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DelayState(NamedTuple):
    buf: torch.Tensor   # (slots, dim)
    idx: int            # next write position


def delay_init(delay_time: float, dt: float, dim: int,
               fill: torch.Tensor | None = None) -> DelayState:
    slots = max(1, int(round(delay_time / dt)) + 1)
    buf = torch.zeros((slots, dim)) if fill is None else fill.expand(slots, dim).clone()
    return DelayState(buf=buf, idx=0)


def delay_step(state: DelayState, x: torch.Tensor) -> tuple[DelayState, torch.Tensor]:
    """Push x, pop the oldest entry (delayed by (slots-1)*dt)."""
    slots = state.buf.shape[0]
    out = state.buf[state.idx].clone()
    buf = state.buf.clone()
    buf[state.idx] = x
    return DelayState(buf=buf, idx=(state.idx + 1) % slots), out
