"""Generalized advantage estimation as a reverse loop over time.

Port of ``algo/gae.py`` (the reference's backward Python loop,
ppo2.py:554-568):
delta_t = r_t + gamma * V_{t+1} * (1 - d_t) - V_t,
A_t = delta_t + gamma * lam * (1 - d_t) * A_{t+1},
where d_t is the done flag *produced by* step t.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def advantages(rewards: torch.Tensor, values: torch.Tensor, dones_after: torch.Tensor,
               last_value: torch.Tensor, gamma: float, lam: float):
    """rewards/values/dones_after: (T, B); last_value: (B,).

    Returns (advantages (T,B), returns (T,B) = adv + values).
    """
    nonterminal = 1.0 - dones_after.to(rewards.dtype)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    # the part of the recursion that does not depend on A_{t+1}, for all steps at once
    deltas = rewards + gamma * next_values * nonterminal - values
    decay = gamma * lam * nonterminal
    advs = torch.empty_like(rewards)
    adv = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = torch.addcmul(deltas[t], decay[t], adv)
        advs[t] = adv
    return advs, advs + values
