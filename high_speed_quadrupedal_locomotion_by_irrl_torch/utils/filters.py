"""First-order low-pass filters used across the stack.

The reference scatters three kinds of exponential filters over C++ and Python
(action filter Environment.hpp:396/:703, obs filter :1251-1256, command filter
:1088-1093, deployment-side filters run_bp_v5.py:352-374); port of
``utils/filters.py``, one pure function for all of them.
"""

from __future__ import annotations

import torch


def lowpass(new: torch.Tensor, prev: torch.Tensor, keep: float | torch.Tensor) -> torch.Tensor:
    """out = keep*prev + (1-keep)*new. keep=0 passes `new` through."""
    return prev * keep + new * (1.0 - keep)


def alpha_from_freq(freq_hz: float, dt: float) -> float:
    """First-order filter coefficient (fraction of *new* sample) for cut-off
    freq at sampling period dt (Environment.hpp:423-427 convention)."""
    w = 2.0 * 3.14 * dt * freq_hz
    return w / (w + 1.0)
