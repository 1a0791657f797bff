"""Caller-driven PPO (PPO3 parity, algo/ppo3/ppo3.py:11-444).

Port of ``algo/ppo3.py``. The caller owns the loop and the environment: it
calls :meth:`PPO3.get_next_action` with each observation, deposits the env's
response with :meth:`PPO3.collect`, and runs GAE and the epochs with
:meth:`PPO3.learn`. The pieces are those of :mod:`.ppo` (the policy of
``ppo_cfg.policy``, ``ppo_loss``, the global-norm clip then Adam(eps 1e-5));
an epoch is one full-batch step. Action noise comes from a
``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as _ppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo.gae import advantages
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm


class PPO3:
    """Caller-driven PPO over an external environment of ``n_envs`` envs, on
    ``device`` (default ``cuda``)."""

    def __init__(self, ppo_cfg: Optional[_ppo.PPOConfig] = None, n_envs: int = 200,
                 seed: int = 0, obs_dim: int = bp.OBS_DIM, act_dim: int = bp.ACT_DIM,
                 device=None):
        self.cfg = ppo_cfg or _ppo.PPOConfig()
        self.pol = self.cfg.policy_mod
        self.device = dev_mod.resolve(device)
        seeds = torch.randint(0, 2 ** 62, (2,), generator=torch.Generator().manual_seed(seed))
        g_init, self.gen = (torch.Generator(device=self.device).manual_seed(int(s))
                            for s in seeds)
        self.params = self.pol.init(g_init, obs_dim, act_dim, self.cfg.n_lstm,
                                    self.device).requires_grad_()
        self.optimizer = _ppo.make_optimizer(self.cfg, self.params)
        self.n_envs = n_envs
        self.lstm_state = torch.zeros((n_envs, self.pol.state_size(self.cfg.n_lstm)),
                                      device=self.device)
        self.dones = torch.zeros(n_envs, device=self.device)
        self._rollout_init_state = self.lstm_state
        self._buf = []           # (obs, action, value, neglogp, done before) a step
        self._rewards = []
        self._dones_after = []
        self._pending_state = self.lstm_state

    def _tensor(self, x) -> torch.Tensor:
        return dev_mod.tensor(np.asarray(x), self.device)

    # --- rollout interface (ppo3.py:372-389 contract) ---------------------------
    @torch.no_grad()
    def get_next_action(self, obs: np.ndarray, deterministic: bool = False) -> np.ndarray:
        """The action for ``obs`` (n_envs, obs_dim), clipped to the action
        bounds; the unclipped one is stored for ``learn``."""
        obs = self._tensor(obs)
        if not self._buf:
            self._rollout_init_state = self.lstm_state
        out = self.pol.forward(self.params, obs, self.lstm_state, self.dones)
        action = out.mean if deterministic else lstm.sample(self.gen, out.mean, out.logstd)
        nlp = lstm.neglogp(out.mean, out.logstd, action)
        self._buf.append((obs, action, out.value, nlp, self.dones))
        self._pending_state = out.state
        return np.clip(action.cpu().numpy(), -1.0, 1.0)

    def collect(self, obs, rewards, dones) -> None:
        """Deposit the env's response to the last action (ppo3.py:387-389)."""
        del obs
        self._rewards.append(self._tensor(rewards))
        d = self._tensor(dones)
        self._dones_after.append(d)
        self.lstm_state = self._pending_state
        self.dones = d

    # --- update (ppo3.py:273-345 contract) --------------------------------------
    def learn(self, last_obs: np.ndarray) -> dict:
        """GAE over what was collected, then ``noptepochs`` full-batch steps.
        Returns the last epoch's metrics, the mean trajectory length
        (``avg_traj_len``) and the mean summed reward an env
        (``average_performance``), and clears the buffers."""
        obs_s, act_s, val_s, nlp_s, db_s = (torch.stack(xs) for xs in zip(*self._buf))
        rew_s, da_s = torch.stack(self._rewards), torch.stack(self._dones_after)
        with torch.no_grad():
            last_value = self.pol.forward(self.params, self._tensor(last_obs), self.lstm_state,
                                          self.dones).value
            _, returns = advantages(rew_s, val_s, da_s, last_value, self.cfg.gamma, self.cfg.lam)
        batch = _ppo.Batch(obs=obs_s, actions=act_s, values=val_s, neglogpacs=nlp_s,
                           returns=returns, dones_before=db_s, rewards=rew_s,
                           init_lstm_state=self._rollout_init_state)
        metrics = {}
        for _ in range(self.cfg.noptepochs):
            metrics = _ppo.train_minibatch(self.params, self.optimizer, batch, self.cfg)
        metrics = {k: float(v) for k, v in metrics.items()}
        # average episode/trajectory length summary (ppo3.py:188-190)
        metrics["avg_traj_len"] = rew_s.numel() / max(float(da_s.sum()) + self.n_envs, 1.0)
        metrics["average_performance"] = float(torch.mean(torch.sum(rew_s, dim=0)))
        self._buf.clear()
        self._rewards.clear()
        self._dones_after.clear()
        return metrics
