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
  ``torch.autograd.Function`` around the sequence: a loop of launches of the
  training-mode forward (which keeps the activated gates), a reverse loop of
  launches of the hand-written backward kernel (which overwrites the gates
  with their gradients), and then the weight gradients as one product each
  over the stacked ``(T*B, .)`` buffers. The Function spans the sequence and
  not a step so that those products are three a tower and not three a step,
  and so that a step costs the host one launch and no autograd node.
  :func:`lstm_cell` and :func:`lstm_cell_pair` with an input that requires
  grad are that Function at T = 1.

For tensors on the CPU all run their plain version under ordinary autograd;
for CUDA tensors they launch the kernels, whose products are their own
register-tiled loops, or raise, never falling back. ``launches`` counts the
launches of the inference forward, ``rows_launches`` those of the per-row
forward, ``train_launches`` those of the training-mode forward and
``bwd_launches`` those of the backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build

launches = 0        # inference-forward launches in this process
rows_launches = 0   # per-row-weights forward launches
train_launches = 0  # training-mode forward launches (gates kept for the backward)
bwd_launches = 0    # backward-kernel launches


@functools.cache
def _fns():
    lib = _build.load("lstm_cell")
    one, pair = lib.lstm_cell_launch, lib.lstm_cell_pair_launch
    train, bwd = lib.lstm_cell_train_launch, lib.lstm_cell_bwd_launch
    rows = lib.lstm_cell_pair_rows_launch
    one.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    pair.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    train.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
    rows.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p] + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    one.restype = pair.restype = train.restype = bwd.restype = rows.restype = ctypes.c_int
    return one, pair, train, bwd, rows


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


class _LayerSequence(torch.autograd.Function):
    """Forward: T launches of the training-mode kernel. Backward: T launches
    of the backward kernel in reverse, then dWx, dWh and db as one product
    each over all steps. Per tower the inputs are (x_seq, c_init, h_init, wx,
    wh, b) and the outputs (c_seq, h_seq).

    The gates kept by the forward are overwritten by the backward with their
    gradients (it saves a second (T, B, 4n) buffer a tower), so a graph can be
    walked back once; a second walk raises."""

    @staticmethod
    def forward(ctx, mask_seq, *flat):
        global train_launches
        towers = len(flat) // 6
        per = [flat[6 * i:6 * i + 6] for i in range(towers)]
        x0, c0, h0, wx0 = per[0][:4]
        if x0.dim() != 3:
            raise ValueError(f"lstm layer: x must be (T, B, d), got {tuple(x0.shape)}")
        (T, B, d), n, device = x0.shape, wx0.shape[1] // 4, x0.device
        if d > n and any(ctx.needs_input_grad[1 + 6 * i] for i in range(towers)):
            # a backward thread owns one column of dh and at most one of dx
            raise ValueError(f"lstm layer: the backward kernel writes a gradient for x only "
                             f"where d <= n, got d = {d}, n = {n}")
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
        fn, stream = _fns()[2], _stream(device)
        sx, sn, sg = 4 * B * d, 4 * B * n, 16 * B * n   # bytes a step
        base = [(x.data_ptr(), cs.data_ptr(), hs.data_ptr(), g.data_ptr(), p[3].data_ptr(),
                 p[4].data_ptr(), p[5].data_ptr())
                for x, cs, hs, g, p in zip(xs, c_seqs, h_seqs, gates, per)]
        mask_ptr = None if mask_seq is None else mask_seq.data_ptr()
        with torch.cuda.device(device):
            for t in range(T):
                ptrs = []
                for (x, cs, hs, g, wx, wh, b), p in zip(base, per):
                    h_in = p[2].data_ptr() if t == 0 else hs + (t - 1) * sn
                    c_in = p[1].data_ptr() if t == 0 else cs + (t - 1) * sn
                    ptrs += [x + t * sx, h_in, c_in, wx, wh, b, hs + t * sn, cs + t * sn,
                             g + t * sg]
                err = fn(_ptr_array(ptrs), None if mask_ptr is None else mask_ptr + 4 * t * B,
                         towers, B, d, n, d, h0.stride(0) if t == 0 else n,
                         c0.stride(0) if t == 0 else n, n, stream)
                _build.check(err, "lstm_cell_train_launch")
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
        dx_cols = d if need_dx else 0
        cols = 1 + -(-dx_cols // n)
        kp = -(-cols * n // 4) * 4
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)  # noqa: E731
        wts = []
        for _, _, wx, wh, _ in per:   # [Wh^T | Wx^T | 0], (4n, kp)
            wt = torch.zeros((4 * n, kp), dtype=torch.float32, device=device)
            wt[:, :n] = wh.T
            if need_dx:
                wt[:, n:n + d] = wx.T
            wts.append(wt)
        d_cs = [None if g is None else g.contiguous() for g in grads[0::2]]
        d_hs = [None if g is None else g.contiguous() for g in grads[1::2]]
        d_xs = [new(T, B, d) if need_dx else None for _ in per]
        rec = [new(2, 2, B, n) for _ in per]   # [ping-pong][dc, dh]
        fn, stream = _fns()[3], _stream(device)
        sx, sn, sg = 4 * B * d, 4 * B * n, 16 * B * n   # bytes a step
        opt = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        # addresses as plain integers, so that a step dispatches no PyTorch op
        base = [(g.data_ptr(), p[0].data_ptr(), cs.data_ptr(), opt(dh), opt(dc), wt.data_ptr(),
                 r.data_ptr(), opt(dx))
                for g, p, cs, dh, dc, wt, r, dx in zip(gates, per, c_seqs, d_hs, d_cs, wts, rec,
                                                       d_xs)]
        mask_ptr = None if mask_seq is None else mask_seq.data_ptr()
        ld_c0 = per[0][0].stride(0)
        with torch.cuda.device(device):
            for t in range(T - 1, -1, -1):
                ptrs = []
                for g, c_init, cs, dh, dc, wt, r, dx in base:
                    # step t reads what step t + 1 wrote into one half of `rec` and writes
                    # the other; the last step reads no recurrent gradient (0: a null pointer)
                    src, dst = r + ((t + 1) % 2) * 2 * sn, r + (t % 2) * 2 * sn
                    rec_on = t < T - 1
                    ptrs += [g + t * sg, c_init if t == 0 else cs + (t - 1) * sn, cs + t * sn,
                             dh and dh + t * sn, src + sn if rec_on else 0,
                             dc and dc + t * sn, src if rec_on else 0,
                             wt, dst, dst + sn, dx and dx + t * sx]
                err = fn(_ptr_array(ptrs), None if mask_ptr is None else mask_ptr + 4 * t * B,
                         towers, B, dx_cols, n, cols, kp, ld_c0 if t == 0 else n, stream)
                _build.check(err, "lstm_cell_bwd_launch")
                bwd_launches += 1
        out = [None]
        keep = None if mask_seq is None else (1.0 - mask_seq)[:, :, None]
        for i, (c_init, h_init, wx, wh, b) in enumerate(per):
            need = ctx.needs_input_grad[1 + 6 * i:7 + 6 * i]
            dg = gates[i].view(T * B, 4 * n)
            d_wx = xs[i].view(T * B, d).T @ dg if need[3] else None
            d_wh = None
            if need[4]:   # the h each step started from: the state before it, after the reset
                h_prev = torch.cat([h_init[None], h_seqs[i][:-1]])
                if keep is not None:
                    h_prev = h_prev * keep
                d_wh = h_prev.view(T * B, n).T @ dg
            d_b = dg.sum(0) if need[5] else None
            out += [d_xs[i] if need[0] else None, rec[i][0][0] if need[1] else None,
                    rec[i][0][1] if need[2] else None, d_wx, d_wh, d_b]
        return tuple(out)

