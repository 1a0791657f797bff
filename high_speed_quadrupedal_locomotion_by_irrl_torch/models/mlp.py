"""Feed-forward actor-critic (FeedForwardPolicy/MlpPolicy parity,
policies.py:395-581), batched.

Port of ``models/mlp.py``: separate policy and value towers of tanh layers
fed the raw observation, a linear value head and a DiagGaussian policy head
with a learned state-independent log-std. It has the call surface of
:mod:`.lstm` so that PPO runs either policy (``models.registry``): the
recurrent "state" is a zero-width placeholder and the done mask is ignored.
The products are ``torch.matmul``: the JAX package computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (  # noqa: F401
    ForwardOut, _ortho, entropy, neglogp, row_product, sample,
)


@dataclasses.dataclass
class MlpParams:
    """Same field names and layouts as the JAX package's ``MlpParams``."""
    pi_layers: tuple[tuple[torch.Tensor, torch.Tensor], ...]   # (w (in, h), b (h,)) a layer
    v_layers: tuple[tuple[torch.Tensor, torch.Tensor], ...]
    pi_w: torch.Tensor    # (h, act)
    pi_b: torch.Tensor    # (act,)
    logstd: torch.Tensor  # (act,)
    vf_w: torch.Tensor    # (h, 1)
    vf_b: torch.Tensor    # (1,)

    def named_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """The parameter tensors in the JAX pytree's order: pi_layers, v_layers
        layer by layer (w, b), then pi_w, pi_b, logstd, vf_w, vf_b."""
        out = [(f"{tower}.{i}.{k}", t)
               for tower in ("pi_layers", "v_layers")
               for i, layer in enumerate(getattr(self, tower)) for k, t in zip("wb", layer)]
        return out + [(k, getattr(self, k)) for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")]

    def leaves(self) -> list[torch.Tensor]:
        return [t for _, t in self.named_leaves()]

    def requires_grad_(self, flag: bool = True) -> "MlpParams":
        """Make every leaf trainable (in place); the leaves an optimizer takes."""
        for t in self.leaves():
            t.requires_grad_(flag)
        return self


def state_size(n_hidden: Sequence[int]) -> int:
    return 0


def init(gen: torch.Generator, obs_dim: int = 35, act_dim: int = 12,
         n_hidden: Sequence[int] = (64, 64), device=None) -> MlpParams:
    """Orthogonal init (tanh layers sqrt(2), pi head 0.01, value head 1,
    logstd 0). ``gen`` must live on ``device``."""
    device = dev_mod.resolve(device)

    def stack():
        layers, d = [], obs_dim
        for h in n_hidden:
            layers.append((_ortho(gen, (d, h), 2.0 ** 0.5, device),
                           torch.zeros(h, device=device)))
            d = h
        return tuple(layers)

    pi, v = stack(), stack()
    h_last = n_hidden[-1]
    return MlpParams(pi_layers=pi, v_layers=v, pi_w=_ortho(gen, (h_last, act_dim), 0.01, device),
                     pi_b=torch.zeros(act_dim, device=device),
                     logstd=torch.zeros(act_dim, device=device),
                     vf_w=_ortho(gen, (h_last, 1), 1.0, device),
                     vf_b=torch.zeros(1, device=device))


def _tower(layers, x: torch.Tensor, product=torch.matmul) -> torch.Tensor:
    for w, b in layers:
        x = torch.tanh(product(x, w) + b)
    return x


def forward(params: MlpParams, obs: torch.Tensor, state: torch.Tensor,
            done: torch.Tensor, stable_rows: bool = False) -> ForwardOut:
    """obs (..., obs_dim) -> means (..., act), values (...); ``state`` is
    passed through and ``done`` ignored. ``stable_rows``: every product
    through ``row_product``, so a row's outputs do not depend on the batch."""
    product = row_product if stable_rows else torch.matmul
    mean = product(_tower(params.pi_layers, obs, product), params.pi_w) + params.pi_b
    value = (product(_tower(params.v_layers, obs, product), params.vf_w) + params.vf_b)[..., 0]
    return ForwardOut(mean=mean, value=value, state=state, logstd=params.logstd)


def sequence(params: MlpParams, obs_seq: torch.Tensor, done_seq: torch.Tensor,
             init_state: torch.Tensor) -> ForwardOut:
    """The (T, B, obs_dim) sequence in one pass: every step is independent."""
    return forward(params, obs_seq, init_state, done_seq)


def deterministic_action(params: MlpParams, obs: torch.Tensor, state: torch.Tensor,
                         done: torch.Tensor):
    out = forward(params, obs, state, done)
    return torch.clamp(out.mean, -1.0, 1.0), out.state
