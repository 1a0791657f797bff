"""PyTorch port: the plain versions of the two LSTM sequence kernels against
autograd and the JAX package.

``ops/lstm_cuda.lstm_layer_forward_plain`` and ``lstm_layer_backward_plain``
write out what ``lstm_seq_train_kernel`` and ``lstm_seq_bwd_kernel``
(csrc/lstm_cell.cu) compute: the forward of one layer over a sequence that
keeps the activated gates, and the reverse recurrence from those gates with
the mask's pre-cell reset, the strided initial state and no recurrent
gradient into the last step; ``layer_weight_grads`` is the three products
after it. Both are held against autograd of ``lstm_layer_sequence_plain``
(the CPU path of the layer) and against ``jax.grad`` of a ``lax.scan`` of the
JAX package's own cell with the reset its ``sequence`` applies, on inputs made
with numpy from a seed. The kernels are held to their plain versions on the
card (tests/test_torch_kernels.py, chip_smoke.py phase 3).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import lstm_cuda
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm

torch.set_num_threads(1)

N = 48
CASES = [(T, B, d, towers, masked, need_dx) for T in (1, 5, 17) for B in (5, 37) for d in (35, 48)
         for towers in (1, 2) for masked in (False, True) for need_dx in (False, True)]


def _problem(T, B, d, towers, masked, seed):
    """numpy inputs of one layer: per tower x (T, B, d), weights, and the
    initial (c, h) as strided views of one packed state; a 0/1 mask (T, B) or
    None; the loss weights (T, B, n) of c' and h' (c' only at B = 5, so that
    the gradient from above into c' is absent at B = 37)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    p = {"state": f(B, 2 * N * towers + 5), "xs": f(T, B, towers * d),
         "mask": (rng.random((T, B)) < 0.3).astype(np.float32) if masked else None}
    for i in range(towers):
        p.update({f"wx{i}": f(d, 4 * N, scale=0.2), f"wh{i}": f(N, 4 * N, scale=0.2),
                  f"b{i}": f(4 * N, scale=0.1), f"wc{i}": f(T, B, N) if B == 5 else None,
                  f"wl{i}": f(T, B, N)})
    return p


def _torch_layer(p, towers, d, grad=False):
    """(leaves, ws, xs, mask, states) of the torch side: every array a tensor,
    the weights, inputs and packed state leaves where ``grad``."""
    lv = {k: torch.from_numpy(v).requires_grad_(grad) for k, v in p.items()
          if v is not None and k[:2] in ("st", "xs", "wx", "wh", "b0", "b1")}
    ws = [tlstm.LSTMWeights(lv[f"wx{i}"], lv[f"wh{i}"], lv[f"b{i}"]) for i in range(towers)]
    xs = [lv["xs"][:, :, i * d:(i + 1) * d] for i in range(towers)]
    states = [(lv["state"][:, 2 * N * i:2 * N * i + N], lv["state"][:, 2 * N * i + N:2 * N * (i + 1)])
              for i in range(towers)]
    mask = None if p["mask"] is None else torch.from_numpy(p["mask"])
    return lv, ws, xs, mask, states


def _upstream(p, towers):
    """[(dc_seq, dh_seq)] a tower: what the loss sends to every c' and h'."""
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return [(t(p[f"wc{i}"]), t(p[f"wl{i}"])) for i in range(towers)]


def _plain_grads(p, towers, d, need_dx):
    """The plain kernels' path: forward, reverse recurrence, weight products.
    -> (fwd, [dict of gradients] a tower)."""
    _, ws, xs, mask, states = _torch_layer(p, towers, d)
    fwd = lstm_cuda.lstm_layer_forward_plain(ws, xs, mask, states)
    bwd = lstm_cuda.lstm_layer_backward_plain(ws, xs, mask, states, fwd, _upstream(p, towers),
                                              need_dx)
    out = []
    for x, (_, h_init), (_, h_seq, _), (dgates, dx, dc, dh) in zip(xs, states, fwd, bwd):
        dwx, dwh, db = lstm_cuda.layer_weight_grads(x, mask, h_init, h_seq, dgates)
        out.append(dict(dgates=dgates, dx=dx, dc=dc, dh=dh, dwx=dwx, dwh=dwh, db=db))
    return fwd, out


def _close(got, want, what, atol, rtol_scale):
    got, want = (np.asarray(a.detach() if isinstance(a, torch.Tensor) else a) for a in (got, want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol + rtol_scale * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("T,B,d,towers,masked,need_dx", CASES)
def test_sequence_kernels_plain_match_autograd(T, B, d, towers, masked, need_dx):
    """Against autograd of lstm_layer_sequence_plain on the same inputs: the
    outputs, the kept gates' gradients summed over the steps (through a (B,
    4n) probe added to the plain cells' bias), dx, the initial state's
    gradients through the strided views of the packed state, and dWx, dWh,
    db; within 1e-6 absolute plus 1e-5 of each gradient's largest entry."""
    p = _problem(T, B, d, towers, masked, seed=T * 1000 + B * 10 + d + towers + 2 * masked)
    fwd, plain = _plain_grads(p, towers, d, need_dx)
    lv, ws, xs, mask, states = _torch_layer(p, towers, d, grad=True)
    probes = [torch.zeros(B, 4 * N, requires_grad=True) for _ in range(towers)]
    ws = [tlstm.LSTMWeights(w.wx, w.wh, w.b + pr) for w, pr in zip(ws, probes)]
    want = lstm_cuda.lstm_layer_sequence_plain(ws, xs, mask, states)
    loss = sum((h * dh).sum() + (0.0 if dc is None else (c * dc).sum())
               for (c, h), (dc, dh) in zip(want, _upstream(p, towers)))
    loss.backward()
    for i, ((c, h, gates), (wc, wh), g) in enumerate(zip(fwd, want, plain)):
        _close(c, wc.detach(), f"c_seq{i}", 1e-6, 0.0)
        _close(h, wh.detach(), f"h_seq{i}", 1e-6, 0.0)
        assert gates.shape == (T, B, 4 * N)
        _close(g["dgates"].sum(0), probes[i].grad, f"dgates{i}", 1e-6, 1e-5)
        _close(g["dc"], lv["state"].grad[:, 2 * N * i:2 * N * i + N], f"dc{i}", 1e-6, 1e-5)
        _close(g["dh"], lv["state"].grad[:, 2 * N * i + N:2 * N * (i + 1)], f"dh{i}", 1e-6, 1e-5)
        for k in ("wx", "wh", "b"):
            _close(g[f"d{k}"], lv[f"{k}{i}"].grad, f"d{k}{i}", 1e-6, 1e-5)
        if need_dx:
            _close(g["dx"], lv["xs"].grad[:, :, i * d:(i + 1) * d], f"dx{i}", 1e-6, 1e-5)
        else:
            assert g["dx"] is None


@functools.cache
def _jax_layer_grads():
    """jax.grad of one tower's layer as the JAX package runs it: lax.scan of
    models/lstm.lstm_cell after the pre-cell reset of its sequence (_tower),
    with a (T, B, 4n) zero probe added to the bias step by step, whose
    gradient is the pre-activation gates' gradient of every step."""
    def loss(wx, wh, b, x, c0, h0, probe, mask, wc, wl):
        def step(carry, inp):
            c, h = carry
            x_t, m_t, p_t, wc_t, wl_t = inp
            keep = (1.0 - m_t)[:, None]
            c, h = jlstm.lstm_cell(jlstm.LSTMWeights(wx=wx, wh=wh, b=b + p_t), x_t, c * keep,
                                   h * keep)
            return (c, h), ((c * wc_t).sum() + (h * wl_t).sum(), c, h)
        _, (terms, cs, hs) = jax.lax.scan(step, (c0, h0), (x, mask, probe, wc, wl))
        return terms.sum(), (cs, hs)
    return jax.jit(jax.grad(loss, argnums=tuple(range(7)), has_aux=True))


@pytest.mark.parametrize("T,B,d,towers,masked,need_dx", CASES)
def test_sequence_kernels_plain_match_jax(T, B, d, towers, masked, need_dx):
    """Against jax.grad of the JAX package's cell under lax.scan, tower by
    tower on the same numpy inputs: the outputs within 1e-5, and every step's
    gate gradients, dx, the initial state's gradients (before its reset) and
    dWx, dWh, db within 1e-5 plus 1e-4 of each one's largest entry."""
    p = _problem(T, B, d, towers, masked, seed=T * 1000 + B * 10 + d + towers + 2 * masked)
    fwd, plain = _plain_grads(p, towers, d, need_dx)
    mask = p["mask"] if masked else np.zeros((T, B), np.float32)
    for i, ((c, h, _), g) in enumerate(zip(fwd, plain)):
        c0 = p["state"][:, 2 * N * i:2 * N * i + N]
        h0 = p["state"][:, 2 * N * i + N:2 * N * (i + 1)]
        wc = p[f"wc{i}"] if p[f"wc{i}"] is not None else np.zeros((T, B, N), np.float32)
        grads, (cs, hs) = _jax_layer_grads()(
            p[f"wx{i}"], p[f"wh{i}"], p[f"b{i}"], p["xs"][:, :, i * d:(i + 1) * d], c0, h0,
            np.zeros((T, B, 4 * N), np.float32), mask, wc, p[f"wl{i}"])
        dwx, dwh, db, dx, dc, dh, dgates = (np.asarray(a) for a in grads)
        _close(c, cs, f"c_seq{i}", 1e-5, 0.0)
        _close(h, hs, f"h_seq{i}", 1e-5, 0.0)
        for k, want in (("dgates", dgates), ("dc", dc), ("dh", dh), ("dwx", dwx), ("dwh", dwh),
                        ("db", db)):
            _close(g[k], want, f"{k}{i}", 1e-5, 1e-4)
        if need_dx:
            _close(g["dx"], dx, f"dx{i}", 1e-5, 1e-4)
