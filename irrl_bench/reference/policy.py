"""Plain PyTorch stacked-LSTM actor-critic (the bp5 CustomLSTMPolicy).

The benchmark's yardstick for the port's LSTM kernels: two towers (policy
and value) of LSTM layers fed the 35-d observation, gate order [i, f, o, g],
the recurrent state packed as [c, h] a layer, policy tower first; a linear
value head and a diagonal Gaussian policy head with a state-independent
log-std. A done flag of the previous step zeroes a row's state before the
cell. The weights are read from the CSV export itself (numpy), never from the
program. Nothing here imports the port.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from irrl_bench.reference.numerics import mm

LOG2PI = math.log(2.0 * math.pi)


class Layer(NamedTuple):
    wx: torch.Tensor   # (in, 4n)
    wh: torch.Tensor   # (n, 4n)
    b: torch.Tensor    # (4n,)


class Weights(NamedTuple):
    pi: tuple          # Layers of the policy tower
    v: tuple           # Layers of the value tower
    pi_w: torch.Tensor
    pi_b: torch.Tensor
    logstd: torch.Tensor
    vf_w: torch.Tensor
    vf_b: torch.Tensor

    def leaves(self) -> list[tuple[str, torch.Tensor]]:
        """(name, tensor) in the port's leaf order (pi towers, v towers, heads)."""
        out = [(f"{tower}_lstm.{i}.{k}", getattr(layer, k))
               for tower in ("pi", "v") for i, layer in enumerate(getattr(self, tower))
               for k in ("wx", "wh", "b")]
        return out + [(k, getattr(self, k)) for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")]


def load_csv(path: str, n_layers: int, device) -> Weights:
    """The bp5 CSV export: lstm_{wx,wh,b}{i}, v_lstm_*, pi_{w,b}, v_{w,b}, logstd."""
    def ld(name):
        a = np.loadtxt(os.path.join(path, name + ".csv"), delimiter=",")
        return torch.tensor(a, dtype=torch.float32, device=device)
    def tower(pre):
        return tuple(Layer(ld(f"{pre}wx{i}"), ld(f"{pre}wh{i}"), ld(f"{pre}b{i}"))
                     for i in range(n_layers))
    return Weights(pi=tower("lstm_"), v=tower("v_lstm_"), pi_w=ld("pi_w"),
                   pi_b=ld("pi_b").reshape(-1), logstd=ld("logstd").reshape(-1),
                   vf_w=ld("v_w").reshape(-1, 1), vf_b=ld("v_b").reshape(-1))


def cell(layer: Layer, x, c, h):
    gates = mm(x, layer.wx) + mm(h, layer.wh) + layer.b
    i, f, o, g = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def _split(w: Weights, state: torch.Tensor):
    sizes = [layer.wh.shape[0] for layer in w.pi + w.v]
    out, off = [], 0
    for n in sizes:
        out.append((state[..., off:off + n], state[..., off + n:off + 2 * n]))
        off += 2 * n
    return out


class Out(NamedTuple):
    mean: torch.Tensor
    value: torch.Tensor
    state: torch.Tensor


def step(w: Weights, obs, state, done) -> Out:
    """One step of both towers: obs (B, 35), state (B, S), done (B,) of the
    previous step."""
    keep = (1.0 - done.float())[:, None]
    chs = _split(w, state)
    new = []
    for tower, first in ((w.pi, 0), (w.v, len(w.pi))):
        x = obs
        for i, layer in enumerate(tower):
            c, h = chs[first + i]
            c, x = cell(layer, x, c * keep, h * keep)
            new += [c, x]
        if first == 0:
            mean = mm(x, w.pi_w) + w.pi_b
        else:
            value = (mm(x, w.vf_w) + w.vf_b)[..., 0]
    return Out(mean=mean, value=value, state=torch.cat(new, dim=-1))


def sequence(w: Weights, obs, dones, state) -> Out:
    """BPTT forward over obs (T, B, 35) and the dones before each step (T, B)
    from state (B, S): means (T, B, 12), values (T, B)."""
    means, values = [], []
    for t in range(obs.shape[0]):
        out = step(w, obs[t], state, dones[t])
        means.append(out.mean)
        values.append(out.value)
        state = out.state
    return Out(mean=torch.stack(means), value=torch.stack(values), state=state)


def neglogp(mean, logstd, action):
    z = (action - mean) / torch.exp(logstd)
    return 0.5 * (z * z).sum(-1) + 0.5 * LOG2PI * action.shape[-1] + logstd.sum(-1)


def entropy(logstd):
    return (logstd + 0.5 * (LOG2PI + 1.0)).sum(-1)
