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

* :func:`lstm_cell_pair_rows` is the pair with one weight set a row
  (``wx`` (B, d, 4n), ``wh`` (B, n, 4n), ``b`` (B, 4n)): the cell that the
  JAX package's ``jax.vmap`` of the policy over stacked, blended parameter
  sets runs (``analysis/landscape.py``). It launches
  ``lstm_cell_pair_rows_kernel``, one block a (row, tower): with per-row
  weights no weight byte is shared between rows, so the pair's tile design
  has nothing to amortize. Inference only: an input that requires grad is
  refused. Its plain version is :func:`..models.lstm.lstm_cell_pair_rows`.

* :func:`lstm_layer_sequence` runs one layer of one tower, or of both, over
  a whole sequence ``(T, B, d)``. Where a gradient is asked for it is one
  ``torch.autograd.Function`` around the sequence: one launch of
  ``lstm_seq_train_kernel``, which walks all T steps with the weights
  resident in shared memory and keeps the activated gates; one launch of
  ``lstm_seq_bwd_kernel``, which walks them back and overwrites the gates
  with their gradients; and then the weight gradients as one product each
  over the stacked ``(T*B, .)`` buffers. A layer costs the host one launch in
  each direction, whatever T. :func:`lstm_cell` and :func:`lstm_cell_pair`
  with an input that requires grad are that Function at T = 1. The plain
  versions of the two kernels are :func:`lstm_layer_forward_plain` and
  :func:`lstm_layer_backward_plain` (the reverse recurrence as the kernel
  computes it, from the kept gates); the plain version of the whole layer,
  which the CPU runs, is :func:`lstm_layer_sequence_plain` under autograd.

For tensors on the CPU all run their plain version under ordinary autograd;
for CUDA tensors they launch the kernels, whose products are their own
register-tiled loops, or raise, never falling back. ``launches`` counts the
launches of the inference forward, ``rows_launches`` those of the per-row
forward, ``train_launches`` those of the sequence forward and
``bwd_launches`` those of the sequence backward: one a layer each.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build

launches = 0        # inference-forward launches in this process
rows_launches = 0   # per-row-weights forward launches
train_launches = 0  # sequence-forward launches (gates kept for the backward), one a layer
bwd_launches = 0    # sequence-backward launches, one a layer


@functools.cache
def _fns():
    lib = _build.load("lstm_cell")
    one, pair = lib.lstm_cell_launch, lib.lstm_cell_pair_launch
    train, bwd = lib.lstm_seq_train_launch, lib.lstm_seq_bwd_launch
    rows, smem = lib.lstm_cell_pair_rows_launch, lib.lstm_seq_smem_bytes
    one.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    pair.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    train.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_size_t
    rows.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    one.restype = pair.restype = train.restype = bwd.restype = rows.restype = ctypes.c_int
    return one, pair, train, bwd, rows, smem


def seq_smem_bytes(backward: bool, d: int, n: int) -> int:
    """Dynamic shared memory a block of the sequence forward, or of the
    backward with ``d`` columns of dx (0: none), asks for (builds the
    kernels' library if it is not built)."""
    return _fns()[5](int(backward), d, n)


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


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _refuse_grad(*tensors) -> None:
    """The raw launches return tensors without a ``grad_fn``: refuse inputs
    that ask for a gradient instead of handing back silent zeros. Inside the
    autograd Function grad mode is off, so its own launches pass."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            "lstm cell: a raw kernel launch was given a tensor that requires grad; it has no "
            "autograd graph. Go through lstm_cell, lstm_cell_pair or lstm_layer_sequence")


def _lstm_cell_kernel(w, x, c, h):
    global launches
    _refuse_grad(x, c, h, w.wx, w.wh, w.b)
    if x.dim() != 2:
        raise ValueError(f"lstm cell: x must be (B, d), got {tuple(x.shape)}")
    (B, d), n, device = x.shape, w.wh.shape[0], x.device
    for name, t, shape in (("x", x, (B, d)), ("c", c, (B, n)), ("h", h, (B, n))):
        _check(name, t, shape, device, rows_may_stride=False)
    _check_weights("", w, d, n, device)
    c_new = torch.empty((B, n), dtype=torch.float32, device=device)
    h_new = torch.empty((B, n), dtype=torch.float32, device=device)
    fn = _fns()[0]
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
    if _wants_grad(x, c, h, w.wx, w.wh, w.b):
        [(c_seq, h_seq)] = lstm_layer_sequence((w,), (x[None],), None, ((c, h),))
        return c_seq[0], h_seq[0]
    return _lstm_cell_kernel(w, x, c, h)


def _lstm_cell_pair_kernel(w0, w1, x0, x1, c0, h0, c1, h1, mask):
    global launches
    _refuse_grad(x0, x1, c0, h0, c1, h1, mask, w0.wx, w0.wh, w0.b, w1.wx, w1.wh, w1.b)
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
    fn = _fns()[1]
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
    if _wants_grad(x0, x1, c0, h0, c1, h1, w0.wx, w0.wh, w0.b, w1.wx, w1.wh, w1.b):
        (cs0, hs0), (cs1, hs1) = lstm_layer_sequence(
            (w0, w1), (x0[None], x1[None]), None if mask is None else mask[None],
            ((c0, h0), (c1, h1)))
        return cs0[0], hs0[0], cs1[0], hs1[0]
    return _lstm_cell_pair_kernel(w0, w1, x0, x1, c0, h0, c1, h1, mask)


# --- one weight set a row ---------------------------------------------------------

def lstm_cell_pair_rows(w0, w1, x0: torch.Tensor, x1: torch.Tensor, c0: torch.Tensor,
                        h0: torch.Tensor, c1: torch.Tensor, h1: torch.Tensor, mask=None):
    """:func:`lstm_cell_pair` with one weight set a row: w.wx (B, d, 4n),
    w.wh (B, n, 4n), w.b (B, 4n) a tower, contiguous; row b of x, c, h runs
    weight set b. Rows of x, c, h may be strided views as in the pair.
    -> (c0', h0', c1', h1'), each (B, n)."""
    global rows_launches
    if x0.device.type == "cpu":
        # imported here: models.lstm imports this module
        from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (
            lstm_cell_pair_rows as plain,
        )
        return plain(w0, w1, x0, x1, c0, h0, c1, h1, mask)
    if x0.device.type != "cuda":
        raise ValueError(f"lstm cell: unsupported device {x0.device}")
    _refuse_grad(x0, x1, c0, h0, c1, h1, mask, w0.wx, w0.wh, w0.b, w1.wx, w1.wh, w1.b)
    if x0.dim() != 2:
        raise ValueError(f"lstm cell: x must be (B, d), got {tuple(x0.shape)}")
    (B, d), n, device = x0.shape, w0.wh.shape[-2], x0.device
    for name, t, shape in (("x0", x0, (B, d)), ("x1", x1, (B, d)), ("c0", c0, (B, n)),
                           ("h0", h0, (B, n)), ("c1", c1, (B, n)), ("h1", h1, (B, n))):
        _check(name, t, shape, device, rows_may_stride=True)
    for a, b, what in ((x0, x1, "x"), (c0, c1, "c"), (h0, h1, "h")):
        if a.stride(0) != b.stride(0):
            raise ValueError(f"lstm cell: the two towers' {what} must have the same row "
                             f"stride, got {a.stride(0)} and {b.stride(0)}")
    for tag, w in (("w0.", w0), ("w1.", w1)):
        for name, t, shape in ((f"{tag}wx", w.wx, (B, d, 4 * n)), (f"{tag}wh", w.wh, (B, n, 4 * n)),
                               (f"{tag}b", w.b, (B, 4 * n))):
            if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape
                    or not t.is_contiguous()):
                raise ValueError(f"lstm cell: {name} must be contiguous float32 {shape} on "
                                 f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if mask is not None:
        _check("mask", mask, (B,), device, rows_may_stride=False)
    # one block [c0' | h0' | c1' | h1'] so that a next layer reads both h' at one stride
    out = torch.empty((B, 4 * n), dtype=torch.float32, device=device)
    c0n, h0n, c1n, h1n = (out[:, i * n:(i + 1) * n] for i in range(4))
    ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in (
        x0, h0, c0, w0.wx, w0.wh, w0.b, h0n, c0n, x1, h1, c1, w1.wx, w1.wh, w1.b, h1n, c1n)))
    fn = _fns()[4]
    with torch.cuda.device(device):
        err = fn(ptrs, None if mask is None else mask.data_ptr(), B, d, n, x0.stride(0),
                 h0.stride(0), c0.stride(0), 4 * n, _stream(device))
    _build.check(err, "lstm_cell_pair_rows_launch")
    rows_launches += 1
    return c0n, h0n, c1n, h1n


# --- a layer over a whole sequence, with its gradient ----------------------------

def _step_loop(cell, pair, ws, xs, mask_seq, states):
    """One layer over time as a loop of single steps through ``cell`` (one
    tower) or ``pair`` (two): -> [(c_seq, h_seq)] a tower, each (T, B, n)."""
    chs = [tuple(s) for s in states]
    seqs = [([], []) for _ in ws]
    for t in range(xs[0].shape[0]):
        m = None if mask_seq is None else mask_seq[t]
        if len(ws) == 2:
            out = pair(ws[0], ws[1], xs[0][t], xs[1][t], *chs[0], *chs[1], m)
            chs = [out[:2], out[2:]]
        else:
            c, h = chs[0]
            if m is not None:
                keep = (1.0 - m)[:, None]
                c, h = c * keep, h * keep
            chs = [cell(ws[0], xs[0][t].contiguous(), c.contiguous(), h.contiguous())]
        for (cs, hs), (c, h) in zip(seqs, chs):
            cs.append(c)
            hs.append(h)
    return [(torch.stack(cs), torch.stack(hs)) for cs, hs in seqs]


def lstm_layer_sequence_plain(ws, xs, mask_seq, states):
    """The plain version of :func:`lstm_layer_sequence`: a loop over time of
    the plain cells under ordinary autograd, on any device."""
    from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as plain
    return _step_loop(plain.lstm_cell, plain.lstm_cell_pair, ws, xs, mask_seq, states)


def _keep(mask_seq, t):
    return None if mask_seq is None else (1.0 - mask_seq[t])[:, None]


def lstm_layer_forward_plain(ws, xs, mask_seq, states):
    """The plain version of ``lstm_seq_train_kernel``: :func:`lstm_layer_sequence`'s
    arguments -> [(c_seq, h_seq, gates)] a tower, with ``gates`` the activated
    [i, f, o, g] of every step, (T, B, 4n), that the backward reads."""
    out = []
    for w, x_seq, (c, h) in zip(ws, xs, states):
        n, cs, hs, gs = w.wh.shape[0], [], [], []
        for t in range(x_seq.shape[0]):
            keep = _keep(mask_seq, t)
            if keep is not None:
                c, h = c * keep, h * keep
            pre = x_seq[t] @ w.wx + h @ w.wh + w.b
            i, f, o = (torch.sigmoid(pre[:, k * n:(k + 1) * n]) for k in range(3))
            g = torch.tanh(pre[:, 3 * n:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            cs.append(c)
            hs.append(h)
            gs.append(torch.cat([i, f, o, g], dim=-1))
        out.append((torch.stack(cs), torch.stack(hs), torch.stack(gs)))
    return out


def lstm_layer_backward_plain(ws, xs, mask_seq, states, fwd, grads, need_dx: bool):
    """The plain version of ``lstm_seq_bwd_kernel``: the reverse recurrence as
    the kernel computes it, from the kept activated gates. ws, xs, mask_seq,
    states: as :func:`lstm_layer_sequence`; fwd: [(c_seq, h_seq, gates)] a
    tower (:func:`lstm_layer_forward_plain`); grads: [(dc_seq, dh_seq)] a
    tower, the gradients that reach every step's c' and h' from above, each
    (T, B, n) or None. -> [(dgates, dx, dc_init, dh_init)] a tower: the
    pre-activation gates' gradients (T, B, 4n), the input's (T, B, d) or None
    without ``need_dx``, and the initial state's (B, n) each, before its
    reset. The weight gradients follow from dgates by
    :func:`layer_weight_grads`."""
    out = []
    for w, x_seq, (c_init, _), (c_seq, _, gates), (dc_up, dh_up) in zip(ws, xs, states, fwd,
                                                                         grads):
        T, n = x_seq.shape[0], w.wh.shape[0]
        dh_rec = dc_rec = torch.zeros_like(c_init)   # none reaches the last step
        dgates, dx = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            i, f, o, g = (gates[t][:, k * n:(k + 1) * n] for k in range(4))
            keep = _keep(mask_seq, t)
            c_prev = c_init if t == 0 else c_seq[t - 1]
            if keep is not None:
                c_prev = c_prev * keep
            tc = torch.tanh(c_seq[t])
            dh = (0.0 if dh_up is None else dh_up[t]) + dh_rec
            dc = (0.0 if dc_up is None else dc_up[t]) + dc_rec
            dct = dc + dh * o * (1.0 - tc * tc)
            dg = torch.cat([dct * g * i * (1.0 - i), dct * c_prev * f * (1.0 - f),
                            dh * tc * o * (1.0 - o), dct * i * (1.0 - g * g)], dim=-1)
            dc_rec, dh_rec = dct * f, dg @ w.wh.T
            if keep is not None:
                dc_rec, dh_rec = dc_rec * keep, dh_rec * keep
            dgates[t] = dg
            if need_dx:
                dx[t] = dg @ w.wx.T
        out.append((torch.stack(dgates), torch.stack(dx) if need_dx else None, dc_rec, dh_rec))
    return out


def layer_weight_grads(x_seq, mask_seq, h_init, h_seq, dgates):
    """dWx, dWh and db of one tower's layer from its gradients of the
    pre-activation gates (T, B, 4n): one product each over the stacked
    (T*B, .) buffers, the h of each step being the state before it after its
    reset."""
    (T, B, d), n4 = x_seq.shape, dgates.shape[-1]
    dg = dgates.reshape(T * B, n4)
    h_prev = torch.cat([h_init[None], h_seq[:-1]])
    if mask_seq is not None:
        h_prev = h_prev * (1.0 - mask_seq)[:, :, None]
    return (x_seq.reshape(T * B, d).T @ dg, h_prev.reshape(T * B, n4 // 4).T @ dg, dg.sum(0))


def lstm_layer_sequence(ws, xs, mask_seq, states):
    """One LSTM layer of one tower (``len(ws) == 1``) or of two independent
    towers of one shape over a sequence. ws: LSTMWeights a tower; xs: inputs a
    tower, (T, B, d); mask_seq: (T, B) or None, rows with mask 1 at step t
    start that step from a zero state; states: (c, h) a tower, each (B, n),
    rows may be strided. -> [(c_seq, h_seq)] a tower, each (T, B, n); the
    final state is ``c_seq[-1], h_seq[-1]``."""
    if len(ws) not in (1, 2) or not len(ws) == len(xs) == len(states):
        raise ValueError("lstm layer: one or two towers, with weights, inputs and a state each")
    device = xs[0].device
    if device.type == "cpu":
        return lstm_layer_sequence_plain(ws, xs, mask_seq, states)
    if device.type != "cuda":
        raise ValueError(f"lstm layer: unsupported device {device}")
    flat = [t for w, x, (c, h) in zip(ws, xs, states) for t in (x, c, h, w.wx, w.wh, w.b)]
    if not _wants_grad(*flat):
        return _step_loop(lstm_cell, lstm_cell_pair, ws, xs, mask_seq, states)
    out = _LayerSequence.apply(mask_seq, *flat)
    return [(out[2 * i], out[2 * i + 1]) for i in range(len(ws))]


def _ptr_array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_seq_shape(n: int) -> None:
    """Raise on a hidden size the sequence kernels do not take: up to 64 and a
    multiple of 4 (blocks of (2n, .) threads; the backward copies its weights
    16 bytes at a time). A layer whose resident [Wx; Wh] passes a block's
    shared memory is refused by the launcher."""
    if not (0 < n <= 64 and n % 4 == 0):
        raise ValueError(f"lstm layer: the sequence kernels take hidden sizes up to 64 that are "
                         f"a multiple of 4, got n = {n}")


class _LayerSequence(torch.autograd.Function):
    """Forward: one launch of the sequence forward. Backward: one launch of
    the sequence backward, then dWx, dWh and db as one product each over all
    steps. Per tower the inputs are (x_seq, c_init, h_init, wx, wh, b) and the
    outputs (c_seq, h_seq).

    The gates kept by the forward are overwritten by the backward with their
    gradients (it saves a second (T, B, 4n) buffer a tower), so a graph can be
    walked back once; a second walk raises."""

    @staticmethod
    def forward(ctx, mask_seq, *flat):
        global train_launches
        towers = len(flat) // 6
        per = [flat[6 * i:6 * i + 6] for i in range(towers)]
        x0, c0, h0, wx0 = per[0][:4]
        if x0.dim() != 3 or x0.shape[0] < 1:
            raise ValueError(f"lstm layer: x must be (T, B, d) with T >= 1, got {tuple(x0.shape)}")
        (T, B, d), n, device = x0.shape, wx0.shape[1] // 4, x0.device
        if d > n and any(ctx.needs_input_grad[1 + 6 * i] for i in range(towers)):
            # a backward thread owns one column of dh and at most one of dx
            raise ValueError(f"lstm layer: the backward kernel writes a gradient for x only "
                             f"where d <= n, got d = {d}, n = {n}")
        _check_seq_shape(n)
        xs = []
        for i, (x, c, h, wx, wh, b) in enumerate(per):
            x = x.contiguous()
            _check(f"x{i}", x.view(T * B, d), (T * B, d), device, rows_may_stride=False)
            _check(f"c{i}", c, (B, n), device, rows_may_stride=True)
            _check(f"h{i}", h, (B, n), device, rows_may_stride=True)
            if (c.stride(0), h.stride(0)) != (c0.stride(0), h0.stride(0)):
                raise ValueError("lstm layer: the two towers' states must have the same row "
                                 "strides")
            _check_weights(f"w{i}.", types.SimpleNamespace(wx=wx, wh=wh, b=b), d, n, device)
            xs.append(x)
        if mask_seq is not None:
            mask_seq = mask_seq.contiguous()
            _check("mask", mask_seq, (T, B), device, rows_may_stride=False)
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)  # noqa: E731
        c_seqs = [new(T, B, n) for _ in per]
        h_seqs = [new(T, B, n) for _ in per]
        gates = [new(T, B, 4 * n) for _ in per]
        ptrs = [t.data_ptr() for x, cs, hs, g, p in zip(xs, c_seqs, h_seqs, gates, per)
                for t in (x, p[2], p[1], p[3], p[4], p[5], cs, hs, g)]
        with torch.cuda.device(device):
            err = _fns()[2](_ptr_array(ptrs), None if mask_seq is None else mask_seq.data_ptr(),
                            towers, T, B, d, n, h0.stride(0), c0.stride(0), _stream(device))
        _build.check(err, f"lstm_seq_train_launch at d = {d}, n = {n} (refused where "
                          f"[Wx; Wh] and the input tiles pass a block's shared memory)")
        train_launches += 1
        ctx.save_for_backward(mask_seq, *xs, *c_seqs, *h_seqs,
                              *(t for p in per for t in p[1:]))
        ctx.gates = gates
        ctx.towers = towers
        ctx.set_materialize_grads(False)
        return tuple(t for pair in zip(c_seqs, h_seqs) for t in pair)

    @staticmethod
    def backward(ctx, *grads):
        global bwd_launches
        if ctx.gates is None:
            raise RuntimeError("lstm layer: the backward overwrote the kept gates with their "
                               "gradients; this graph cannot be walked back a second time")
        towers, gates = ctx.towers, ctx.gates
        ctx.gates = None
        saved = ctx.saved_tensors
        mask_seq, saved = saved[0], saved[1:]
        xs, c_seqs, h_seqs = (saved[i * towers:(i + 1) * towers] for i in range(3))
        rest = saved[3 * towers:]
        per = [rest[5 * i:5 * i + 5] for i in range(towers)]   # c_init, h_init, wx, wh, b
        (T, B, d), n, device = xs[0].shape, c_seqs[0].shape[2], xs[0].device
        need_dx = any(ctx.needs_input_grad[1 + 6 * i] for i in range(towers))
        cols = 2 if need_dx else 1
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)  # noqa: E731
        wts = []
        for _, _, wx, wh, _ in per:   # [j][u] = (Wh^T[j][u], Wx^T[j][u] or 0), (4n, n, cols)
            wt = torch.zeros((4 * n, n, cols), dtype=torch.float32, device=device)
            wt[:, :, 0] = wh.T
            if need_dx:
                wt[:, :d, 1] = wx.T
            wts.append(wt)
        d_cs = [None if g is None else g.contiguous() for g in grads[0::2]]
        d_hs = [None if g is None else g.contiguous() for g in grads[1::2]]
        d_xs = [new(T, B, d) if need_dx else None for _ in per]
        d_init = [new(2, B, n) for _ in per]   # [dc, dh] of the initial state
        opt = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        ptrs = [v for g, p, cs, dh, dc, wt, d0, dx in zip(gates, per, c_seqs, d_hs, d_cs, wts,
                                                         d_init, d_xs)
                for v in (g.data_ptr(), p[0].data_ptr(), cs.data_ptr(), opt(dh), opt(dc),
                          wt.data_ptr(), d0[0].data_ptr(), d0[1].data_ptr(), opt(dx))]
        with torch.cuda.device(device):
            err = _fns()[3](_ptr_array(ptrs), None if mask_seq is None else mask_seq.data_ptr(),
                            towers, T, B, d if need_dx else 0, n, per[0][0].stride(0),
                            _stream(device))
        _build.check(err, "lstm_seq_bwd_launch")
        bwd_launches += 1
        out = [None]
        for i, (c_init, h_init, wx, wh, b) in enumerate(per):
            need = ctx.needs_input_grad[1 + 6 * i:7 + 6 * i]
            d_wx, d_wh, d_b = (layer_weight_grads(xs[i], mask_seq, h_init, h_seqs[i], gates[i])
                               if any(need[3:]) else (None, None, None))
            out += [d_xs[i] if need[0] else None, d_init[i][0] if need[1] else None,
                    d_init[i][1] if need[2] else None, d_wx if need[3] else None,
                    d_wh if need[4] else None, d_b if need[5] else None]
        return tuple(out)
