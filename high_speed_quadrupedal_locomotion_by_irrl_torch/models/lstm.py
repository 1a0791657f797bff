"""Stacked-LSTM actor-critic (the bp5 CustomLSTMPolicy), batched.

Port of ``models/lstm.py``: separate policy and value towers, each a stack of
LSTM(48) layers fed the raw 35-d observation, a linear value head and a
DiagGaussian policy head with a learned state-independent log-std. Gate order
is [input, forget, output, candidate]; the packed recurrent state is [c, h]
per layer, pi tower first, then the value tower (CustomerLstmNN.py:112-134).

The two towers are independent, so :func:`forward` steps layer l of both in
one call of :func:`..ops.lstm_cuda.lstm_cell_pair`, the hand-written CUDA
kernel on the card: one launch a layer. Where the towers differ in depth or
width, such a layer goes through :func:`..ops.lstm_cuda.lstm_cell`, one launch
a tower. :func:`lstm_cell` and :func:`lstm_cell_pair` here are the kernel's
plain PyTorch versions.

A ``PolicyParams`` whose leaves carry a leading row axis ``B`` (one weight
set a row, as :func:`..analysis.landscape.blend_params` stacks them) runs
:func:`forward` and :func:`deterministic_action` with row b on weight set b:
what the JAX package's ``jax.vmap(lstm.deterministic_action)`` over stacked
params computes. Its layers go through
:func:`..ops.lstm_cuda.lstm_cell_pair_rows` (the per-row kernel on the card;
its plain version :func:`lstm_cell_pair_rows` here), its heads are batched
products.

:func:`sequence` is the BPTT forward. It walks the stack layer by layer, each
layer over the whole sequence through
:func:`..ops.lstm_cuda.lstm_layer_sequence` (on the card one launch of the
sequence forward kernel and, in the backward pass, one of the sequence
backward kernel, for both towers; on the CPU the plain cells under autograd). A layer depends only on the layer below, so
this computes what a loop over time of :func:`forward` computes, and the heads
are applied once to the stacked latents.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import lstm_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling

LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class LSTMWeights:
    wx: torch.Tensor  # (in, 4h)
    wh: torch.Tensor  # (h, 4h)
    b: torch.Tensor   # (4h,)


@dataclasses.dataclass
class PolicyParams:
    """Same field names and layouts as the JAX package's ``PolicyParams``."""
    pi_lstm: tuple[LSTMWeights, ...]
    v_lstm: tuple[LSTMWeights, ...]
    pi_w: torch.Tensor    # (h, act)
    pi_b: torch.Tensor    # (act,)
    logstd: torch.Tensor  # (act,)
    vf_w: torch.Tensor    # (h, 1)
    vf_b: torch.Tensor    # (1,)

    def named_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """The parameter tensors in a fixed order (the JAX pytree's): pi_lstm,
        v_lstm layer by layer (wx, wh, b), then pi_w, pi_b, logstd, vf_w, vf_b."""
        out = [(f"{tower}.{i}.{k}", getattr(w, k))
               for tower in ("pi_lstm", "v_lstm")
               for i, w in enumerate(getattr(self, tower)) for k in ("wx", "wh", "b")]
        return out + [(k, getattr(self, k)) for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")]

    def leaves(self) -> list[torch.Tensor]:
        return [t for _, t in self.named_leaves()]

    def requires_grad_(self, flag: bool = True) -> "PolicyParams":
        """Make every leaf trainable (in place); the leaves an optimizer takes."""
        for t in self.leaves():
            t.requires_grad_(flag)
        return self


def state_size(n_lstm: Sequence[int]) -> int:
    """Total recurrent state (c and h for both towers): sum(n)*2*2."""
    return sum(n_lstm) * 4


def _ortho(gen: torch.Generator, shape, scale, device):
    a = torch.randn(shape if shape[0] >= shape[1] else shape[::-1], generator=gen,
                    device=device, dtype=dev_mod.DTYPE)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q = q if shape[0] >= shape[1] else q.T
    return scale * q[: shape[0], : shape[1]]


def init(gen: torch.Generator, obs_dim: int = 35, act_dim: int = 12,
         n_lstm: Sequence[int] = (48, 48), device=None) -> PolicyParams:
    """Orthogonal init matching stable-baselines defaults (lstm init_scale=1,
    vf init_scale=1, pi head init_scale=0.01, logstd=0). ``gen`` must live on
    ``device``."""
    device = dev_mod.resolve(device)

    def make_stack():
        stack, d = [], obs_dim
        for h in n_lstm:
            stack.append(LSTMWeights(wx=_ortho(gen, (d, 4 * h), 1.0, device),
                                     wh=_ortho(gen, (h, 4 * h), 1.0, device),
                                     b=torch.zeros(4 * h, device=device)))
            d = h
        return tuple(stack)

    pi_stack, v_stack = make_stack(), make_stack()
    h_last = n_lstm[-1]
    return PolicyParams(
        pi_lstm=pi_stack, v_lstm=v_stack,
        pi_w=_ortho(gen, (h_last, act_dim), 0.01, device),
        pi_b=torch.zeros(act_dim, device=device), logstd=torch.zeros(act_dim, device=device),
        vf_w=_ortho(gen, (h_last, 1), 1.0, device), vf_b=torch.zeros(1, device=device))


def lstm_cell(w: LSTMWeights, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One LSTM step, gate order [i, f, o, g] (CustomerLstmNN.py:119-126).
    The plain version of the CUDA kernel in ops/lstm_cuda.py."""
    return _cell_tail(x @ w.wx + h @ w.wh + w.b, c)


def lstm_cell_rows(w: LSTMWeights, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """:func:`lstm_cell` with one weight set a row: w.wx (B, d, 4n), w.wh
    (B, n, 4n), w.b (B, 4n); x (B, d), c and h (B, n)."""
    gates = (torch.bmm(x[:, None], w.wx) + torch.bmm(h[:, None], w.wh))[:, 0] + w.b
    return _cell_tail(gates, c)


def _cell_tail(gates: torch.Tensor, c: torch.Tensor):
    """(c', h') from the pre-activation gates [i, f, o, g] and c."""
    n = gates.shape[-1] // 4
    i = torch.sigmoid(gates[..., 0 * n:1 * n])
    f = torch.sigmoid(gates[..., 1 * n:2 * n])
    o = torch.sigmoid(gates[..., 2 * n:3 * n])
    g = torch.tanh(gates[..., 3 * n:4 * n])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return c_new, h_new


def _split_state(params: PolicyParams, state: torch.Tensor):
    """(..., S) packed state -> list of (c, h) per layer, pi then v."""
    sizes = [w.wh.shape[-2] for w in params.pi_lstm] + [w.wh.shape[-2] for w in params.v_lstm]
    out, off = [], 0
    for n in sizes:
        out.append((state[..., off:off + n], state[..., off + n:off + 2 * n]))
        off += 2 * n
    return out


def lstm_cell_pair(w0: LSTMWeights, w1: LSTMWeights, x0, x1, c0, h0, c1, h1, mask=None):
    """The same layer of two independent towers in one call, with the
    pre-cell state reset (a2c.utils.lstm): rows with mask 1 start from a zero
    state. -> (c0', h0', c1', h1'). The plain version of the CUDA pair launch
    in ops/lstm_cuda.py: two plain cells with the mask applied."""
    if mask is not None:
        keep = (1.0 - mask)[..., None]
        c0, h0, c1, h1 = c0 * keep, h0 * keep, c1 * keep, h1 * keep
    return lstm_cell(w0, x0, c0, h0) + lstm_cell(w1, x1, c1, h1)


def lstm_cell_pair_rows(w0: LSTMWeights, w1: LSTMWeights, x0, x1, c0, h0, c1, h1, mask=None):
    """:func:`lstm_cell_pair` with one weight set a row (:func:`lstm_cell_rows`).
    The plain version of the per-row CUDA launch in ops/lstm_cuda.py."""
    if mask is not None:
        keep = (1.0 - mask)[..., None]
        c0, h0, c1, h1 = c0 * keep, h0 * keep, c1 * keep, h1 * keep
    return lstm_cell_rows(w0, x0, c0, h0) + lstm_cell_rows(w1, x1, c1, h1)


def per_row(params: PolicyParams) -> bool:
    """Whether the leaves carry a leading row axis (one weight set a row)."""
    return params.pi_b.dim() == 2


def _reset_cell(w: LSTMWeights, x, c, h, mask):
    """One tower's cell after the pre-cell state reset, through the single-cell
    kernel entry."""
    keep = (1.0 - mask)[..., None]
    return lstm_cuda.lstm_cell(w, x.contiguous(), c * keep, h * keep)


def row_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x (..., k), w (k, n)) as a product and a sum over k, whose
    bits in a row do not depend on how many rows there are: cuBLAS picks its
    algorithm, and with it a row's rounding, by the batch's width. The
    training rollout computes its heads so, and W ranks of B / W envs then
    act as one rank of B envs does."""
    return (x.unsqueeze(-2) * w.T).sum(-1)


class ForwardOut(NamedTuple):
    mean: torch.Tensor      # (B, act)
    value: torch.Tensor     # (B,)
    state: torch.Tensor     # (B, S) new packed recurrent state
    logstd: torch.Tensor    # (act,)


def forward(params: PolicyParams, obs: torch.Tensor, state: torch.Tensor,
            done: torch.Tensor, stable_rows: bool = False) -> ForwardOut:
    """Single-step forward (act model). obs (B, 35), state (B, S), done (B,):
    the done mask of the *previous* step resets the state. With per-row
    params (:func:`per_row`) row b runs weight set b; logstd is then (B, act).
    ``stable_rows``: the heads through :func:`row_product` (the cells work
    row by row already), so a row's outputs do not depend on B."""
    chs = _split_state(params, state)
    n_pi, n_v = len(params.pi_lstm), len(params.v_lstm)
    mask = done.to(obs.dtype).contiguous()
    pi_latent = v_latent = obs.contiguous()
    pi_chs, v_chs = [], []
    rows = per_row(params)
    pair = lstm_cuda.lstm_cell_pair_rows if rows else lstm_cuda.lstm_cell_pair
    for layer in range(max(n_pi, n_v)):
        w_pi = params.pi_lstm[layer] if layer < n_pi else None
        w_v = params.v_lstm[layer] if layer < n_v else None
        if (w_pi is not None and w_v is not None and w_pi.wx.shape == w_v.wx.shape
                and w_pi.wh.shape == w_v.wh.shape):
            (c_pi, h_pi), (c_v, h_v) = chs[layer], chs[n_pi + layer]
            c_pi, pi_latent, c_v, v_latent = pair(
                w_pi, w_v, pi_latent, v_latent, c_pi, h_pi, c_v, h_v, mask)
            pi_chs.append((c_pi, pi_latent))
            v_chs.append((c_v, v_latent))
            continue
        # towers that differ here in depth or width: one cell launch a tower (with one
        # weight set a row, the per-row launch with the tower as both of its towers)
        if rows:
            cell = lambda w, x, c, h: pair(w, w, x, x, c, h, c, h, mask)[:2]  # noqa: E731
        else:
            cell = lambda w, x, c, h: _reset_cell(w, x, c, h, mask)  # noqa: E731
        if w_pi is not None:
            c_pi, pi_latent = cell(w_pi, pi_latent, *chs[layer])
            pi_chs.append((c_pi, pi_latent))
        if w_v is not None:
            c_v, v_latent = cell(w_v, v_latent, *chs[n_pi + layer])
            v_chs.append((c_v, v_latent))
    if rows:
        mean = torch.bmm(pi_latent[:, None], params.pi_w)[:, 0] + params.pi_b
        value = (torch.bmm(v_latent[:, None], params.vf_w)[:, 0] + params.vf_b)[..., 0]
    else:
        product = row_product if stable_rows else torch.matmul
        mean = product(pi_latent, params.pi_w) + params.pi_b
        value = (product(v_latent, params.vf_w) + params.vf_b)[..., 0]
    packed = torch.cat([t for ch in pi_chs + v_chs for t in ch], dim=-1)
    return ForwardOut(mean=mean, value=value, state=packed, logstd=params.logstd)


@profiling.span("lstm.sequence")
def sequence(params: PolicyParams, obs_seq: torch.Tensor, done_seq: torch.Tensor,
             init_state: torch.Tensor) -> ForwardOut:
    """BPTT forward over (T, B, 35) obs and (T, B) dones from the (B, S)
    initial state: means (T, B, act), values (T, B) and the final state."""
    chs = _split_state(params, init_state)
    n_pi, n_v = len(params.pi_lstm), len(params.v_lstm)
    mask = done_seq.to(obs_seq.dtype)
    pi_latent = v_latent = obs_seq
    pi_last, v_last = [], []
    for layer in range(max(n_pi, n_v)):
        w_pi = params.pi_lstm[layer] if layer < n_pi else None
        w_v = params.v_lstm[layer] if layer < n_v else None
        if (w_pi is not None and w_v is not None and w_pi.wx.shape == w_v.wx.shape
                and w_pi.wh.shape == w_v.wh.shape):
            (c_pi, pi_latent), (c_v, v_latent) = lstm_cuda.lstm_layer_sequence(
                (w_pi, w_v), (pi_latent, v_latent), mask, (chs[layer], chs[n_pi + layer]))
            pi_last.append((c_pi[-1], pi_latent[-1]))
            v_last.append((c_v[-1], v_latent[-1]))
            continue
        if w_pi is not None:
            [(c_pi, pi_latent)] = lstm_cuda.lstm_layer_sequence(
                (w_pi,), (pi_latent,), mask, (chs[layer],))
            pi_last.append((c_pi[-1], pi_latent[-1]))
        if w_v is not None:
            [(c_v, v_latent)] = lstm_cuda.lstm_layer_sequence(
                (w_v,), (v_latent,), mask, (chs[n_pi + layer],))
            v_last.append((c_v[-1], v_latent[-1]))
    mean = pi_latent @ params.pi_w + params.pi_b
    value = (v_latent @ params.vf_w + params.vf_b)[..., 0]
    packed = torch.cat([t for ch in pi_last + v_last for t in ch], dim=-1)
    return ForwardOut(mean=mean, value=value, state=packed, logstd=params.logstd)


# --- DiagGaussian distribution ops (stable-baselines distributions parity) ----

def sample(gen: torch.Generator, mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
    noise = dev_mod.randn(gen, mean.shape, mean.device, mean.dtype)
    return mean + torch.exp(logstd) * noise


def neglogp(mean: torch.Tensor, logstd: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    z = (action - mean) / torch.exp(logstd)
    return (0.5 * torch.sum(z * z, dim=-1)
            + 0.5 * LOG2PI * action.shape[-1]
            + torch.sum(logstd, dim=-1))


def entropy(logstd: torch.Tensor) -> torch.Tensor:
    return torch.sum(logstd + 0.5 * (LOG2PI + 1.0), dim=-1)


def deterministic_action(params: PolicyParams, obs: torch.Tensor,
                         state: torch.Tensor, done: torch.Tensor):
    """Deployment predict: clipped deterministic action
    (CustomerLstmNN.predict clips to +-1, CustomerLstmNN.py:133-134)."""
    out = forward(params, obs, state, done)
    return torch.clamp(out.mean, -1.0, 1.0), out.state
