"""Plain PyTorch PPO optimizer steps on a rollout's batch (the PPO2 objective).

Clipped surrogate plus clipped value loss (and the entropy bonus) over whole
sequences with BPTT through :mod:`.policy`, advantages normalized over the
batch (population statistics), the gradient clipped to a global norm (scaled
by max_norm / max(norm, max_norm)), then Adam. With one minibatch a step
sees every env; the loss is a mean over all (step, env) samples, so the
reference walks the envs in blocks, each block's sums over the global count,
and adds the gradients: the same loss in less memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from irrl_bench.reference import policy


class Batch(NamedTuple):
    obs: torch.Tensor           # (T, B, 35)
    actions: torch.Tensor       # (T, B, 12)
    values: torch.Tensor        # (T, B)
    neglogpacs: torch.Tensor    # (T, B)
    returns: torch.Tensor       # (T, B)
    dones_before: torch.Tensor  # (T, B)
    init_state: torch.Tensor    # (B, S)


def _block_loss(w: policy.Weights, b: Batch, lo: int, hi: int, adv_mean, adv_std, n: int,
                ppo: dict):
    """This block's part of the loss: its sums over the global count ``n``."""
    take = lambda x: x[:, lo:hi]  # noqa: E731
    seq = policy.sequence(w, take(b.obs), take(b.dones_before), b.init_state[lo:hi])
    nlp = policy.neglogp(seq.mean, w.logstd, take(b.actions))
    values, returns = take(b.values), take(b.returns)
    advs = (returns - values - adv_mean) / (adv_std + 1e-8)
    clip = ppo["clip_range"]
    v_clipped = values + torch.clamp(seq.value - values, -clip, clip)
    vf = 0.5 * torch.maximum((seq.value - returns) ** 2, (v_clipped - returns) ** 2).sum() / n
    ratio = torch.exp(take(b.neglogpacs) - nlp)
    pg = torch.maximum(-advs * ratio, -advs * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)).sum() / n
    return pg + vf * ppo["vf_coef"]


class Adam:
    """Adam with bias correction, as ``torch.optim.Adam`` defines it."""

    def __init__(self, leaves: list, lr: float, betas, eps: float):
        self.lr, (self.b1, self.b2), self.eps, self.t = lr, betas, eps, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, leaves: list, grads: list) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


class Steps(NamedTuple):
    losses: list          # the loss before each step
    grads: list           # the clipped gradient of each step, by leaf name
    params: list          # the parameters after each step, by leaf name


def train_steps(w: policy.Weights, b: Batch, ppo: dict, n_steps: int, block: int) -> Steps:
    """``n_steps`` optimizer steps from ``w`` on the whole batch ``b``."""
    names = [k for k, _ in w.leaves()]
    leaves = [t.clone().requires_grad_(True) for _, t in w.leaves()]
    rebuild = lambda: _weights(w, leaves)  # noqa: E731
    adam = Adam(leaves, ppo["learning_rate"], ppo["adam_betas"], ppo["adam_eps"])
    T, B = b.values.shape
    n = T * B
    adv = (b.returns - b.values).double()
    adv_mean = adv.mean().float()
    adv_std = adv.std(correction=0).float()
    out = Steps([], [], [])
    for _ in range(n_steps):
        for p in leaves:
            p.grad = None
        wk = rebuild()
        loss = -policy.entropy(wk.logstd) * ppo["ent_coef"]
        loss.backward()
        total = float(loss.detach())
        for lo in range(0, B, block):
            part = _block_loss(rebuild(), b, lo, min(B, lo + block), adv_mean, adv_std, n, ppo)
            part.backward()
            total += float(part.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            scale = ppo["max_grad_norm"] / torch.clamp(norm, min=ppo["max_grad_norm"])
            grads = [g * scale for g in grads]
        adam.step(leaves, grads)
        out.losses.append(total)
        out.grads.append({k: g.detach().clone() for k, g in zip(names, grads)})
        out.params.append({k: p.detach().clone() for k, p in zip(names, leaves)})
    return out


def _weights(w: policy.Weights, leaves: list) -> policy.Weights:
    """``w``'s structure over the tensors ``leaves`` (in ``w.leaves()`` order)."""
    it = iter(leaves)
    tower = lambda layers: tuple(policy.Layer(next(it), next(it), next(it))  # noqa: E731
                                 for _ in layers)
    pi = tower(w.pi)
    v = tower(w.v)
    return policy.Weights(pi=pi, v=v, pi_w=next(it), pi_b=next(it), logstd=next(it),
                          vf_w=next(it), vf_b=next(it))
