"""Fused LSTM cell as a hand-written CUDA kernel (``csrc/lstm_cell.cu``).

Replaces the JAX package's TPU kernel ``ops/lstm_pallas.py::_kernel``.
:func:`lstm_cell` takes the same arguments as the plain
:func:`..models.lstm.lstm_cell` and returns ``(c_new, h_new)``. For tensors on
the CPU it runs that plain version; for CUDA tensors it launches the kernel,
whose gate products are its own loops over shared memory, or raises, never
falling back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build

launches = 0  # kernel launches made by lstm_cell() in this process


@functools.cache
def _fn():
    lib = _build.load("lstm_cell")
    fn = lib.lstm_cell_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lstm_cell(w, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One LSTM step, gate order [i, f, o, g]: x (B, d), c and h (B, n),
    w.wx (d, 4n), w.wh (n, 4n), w.b (4n,) -> (c_new, h_new), each (B, n)."""
    global launches
    if x.device.type == "cpu":
        # imported here: models.lstm imports this module
        from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (
            lstm_cell as plain,
        )
        return plain(w, x, c, h)
    if x.device.type != "cuda":
        raise ValueError(f"lstm cell: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"lstm cell: x must be (B, d), got {tuple(x.shape)}")
    B, d = x.shape
    n = w.wh.shape[0]
    for name, t, shape in (("x", x, (B, d)), ("c", c, (B, n)), ("h", h, (B, n)),
                           ("wx", w.wx, (d, 4 * n)), ("wh", w.wh, (n, 4 * n)),
                           ("b", w.b, (4 * n,))):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"lstm cell: {name} must be float32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm cell: {name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"lstm cell: {name} must be contiguous")
    c_new = torch.empty((B, n), dtype=torch.float32, device=x.device)
    h_new = torch.empty((B, n), dtype=torch.float32, device=x.device)
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), w.wx.data_ptr(), w.wh.data_ptr(),
                 w.b.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), B, d, n, stream)
    _build.check(err, "lstm_cell_launch")
    launches += 1
    return c_new, h_new
