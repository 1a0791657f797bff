"""Fused LSTM cell as a hand-written CUDA kernel (``csrc/lstm_cell.cu``).

Replaces the JAX package's TPU kernel ``ops/lstm_pallas.py::_kernel``. Two
entry points over one device body:

* :func:`lstm_cell` takes the same arguments as the plain
  :func:`..models.lstm.lstm_cell` and returns ``(c_new, h_new)``: the function
  the TPU kernel computes.
* :func:`lstm_cell_pair` steps the same layer of two independent towers in
  one launch, with the pre-cell state reset (``c``, ``h`` scaled by
  ``1 - mask``) folded in. Its plain version is
  :func:`..models.lstm.lstm_cell_pair`.

For tensors on the CPU both run their plain version; for CUDA tensors they
launch the kernel, whose gate products are its own register-tiled loops, or
raise, never falling back. ``launches`` counts the kernel launches of both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build

launches = 0  # kernel launches made by lstm_cell() and lstm_cell_pair() in this process


@functools.cache
def _fns():
    lib = _build.load("lstm_cell")
    one, pair = lib.lstm_cell_launch, lib.lstm_cell_pair_launch
    one.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    pair.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    one.restype = pair.restype = ctypes.c_int
    return one, pair


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name: str, t: torch.Tensor, shape: tuple, device, rows_may_stride: bool) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"lstm cell: {name} must be float32 on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"lstm cell: {name} must have shape {shape}, got {tuple(t.shape)}")
    if rows_may_stride:
        if t.stride(1) != 1 or t.stride(0) < shape[1]:
            raise ValueError(f"lstm cell: {name} must be contiguous along its last axis, "
                             f"got strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"lstm cell: {name} must be contiguous")


def _check_weights(tag: str, w, d: int, n: int, device) -> None:
    for name, t, shape in ((f"{tag}wx", w.wx, (d, 4 * n)), (f"{tag}wh", w.wh, (n, 4 * n)),
                           (f"{tag}b", w.b, (4 * n,))):
        _check(name, t, shape, device, rows_may_stride=False)
        if t.data_ptr() % 16:   # the kernel copies weight rows 16 bytes at a time
            raise ValueError(f"lstm cell: {name} must be 16-byte aligned")


def _lstm_cell_kernel(w, x, c, h):
    global launches
    if x.dim() != 2:
        raise ValueError(f"lstm cell: x must be (B, d), got {tuple(x.shape)}")
    (B, d), n, device = x.shape, w.wh.shape[0], x.device
    for name, t, shape in (("x", x, (B, d)), ("c", c, (B, n)), ("h", h, (B, n))):
        _check(name, t, shape, device, rows_may_stride=False)
    _check_weights("", w, d, n, device)
    c_new = torch.empty((B, n), dtype=torch.float32, device=device)
    h_new = torch.empty((B, n), dtype=torch.float32, device=device)
    fn, _ = _fns()
    with torch.cuda.device(device):
        err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), w.wx.data_ptr(), w.wh.data_ptr(),
                 w.b.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), B, d, n, _stream(device))
    _build.check(err, "lstm_cell_launch")
    launches += 1
    return c_new, h_new


def lstm_cell(w, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One LSTM step, gate order [i, f, o, g]: x (B, d), c and h (B, n),
    w.wx (d, 4n), w.wh (n, 4n), w.b (4n,) -> (c_new, h_new), each (B, n)."""
    if x.device.type == "cpu":
        # imported here: models.lstm imports this module
        from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (
            lstm_cell as plain,
        )
        return plain(w, x, c, h)
    if x.device.type != "cuda":
        raise ValueError(f"lstm cell: unsupported device {x.device}")
    return _lstm_cell_kernel(w, x, c, h)


def _lstm_cell_pair_kernel(w0, w1, x0, x1, c0, h0, c1, h1, mask):
    global launches
    if x0.dim() != 2:
        raise ValueError(f"lstm cell: x must be (B, d), got {tuple(x0.shape)}")
    (B, d), n, device = x0.shape, w0.wh.shape[0], x0.device
    for name, t, shape in (("x0", x0, (B, d)), ("x1", x1, (B, d)), ("c0", c0, (B, n)),
                           ("h0", h0, (B, n)), ("c1", c1, (B, n)), ("h1", h1, (B, n))):
        _check(name, t, shape, device, rows_may_stride=True)
    for a, b, what in ((x0, x1, "x"), (c0, c1, "c"), (h0, h1, "h")):
        if a.stride(0) != b.stride(0):
            raise ValueError(f"lstm cell: the two towers' {what} must have the same row "
                             f"stride, got {a.stride(0)} and {b.stride(0)}")
    _check_weights("w0.", w0, d, n, device)
    _check_weights("w1.", w1, d, n, device)
    if mask is not None:
        _check("mask", mask, (B,), device, rows_may_stride=False)
    # one block [c0' | h0' | c1' | h1'] so that a next layer reads both h' at one stride
    out = torch.empty((B, 4 * n), dtype=torch.float32, device=device)
    c0n, h0n, c1n, h1n = (out[:, i * n:(i + 1) * n] for i in range(4))
    ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in (
        x0, h0, c0, w0.wx, w0.wh, w0.b, h0n, c0n, x1, h1, c1, w1.wx, w1.wh, w1.b, h1n, c1n)))
    _, fn = _fns()
    with torch.cuda.device(device):
        err = fn(ptrs, None if mask is None else mask.data_ptr(), B, d, n, x0.stride(0),
                 h0.stride(0), c0.stride(0), 4 * n, _stream(device))
    _build.check(err, "lstm_cell_pair_launch")
    launches += 1
    return c0n, h0n, c1n, h1n


def lstm_cell_pair(w0, w1, x0: torch.Tensor, x1: torch.Tensor, c0: torch.Tensor,
                   h0: torch.Tensor, c1: torch.Tensor, h1: torch.Tensor, mask=None):
    """One step of the same layer of two independent towers, gate order
    [i, f, o, g]. x0, x1 (B, d); c0, h0, c1, h1 (B, n); both weight sets as in
    :func:`lstm_cell`; mask (B,) or None: rows with mask 1 start from a zero
    state. Rows may be strided views (unit stride along the last axis, the
    two towers at equal row strides). -> (c0', h0', c1', h1'), each (B, n)."""
    if x0.device.type == "cpu":
        # imported here: models.lstm imports this module
        from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (
            lstm_cell_pair as plain,
        )
        return plain(w0, w1, x0, x1, c0, h0, c1, h1, mask)
    if x0.device.type != "cuda":
        raise ValueError(f"lstm cell: unsupported device {x0.device}")
    return _lstm_cell_pair_kernel(w0, w1, x0, x1, c0, h0, c1, h1, mask)
