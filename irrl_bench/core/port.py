"""The port's configuration objects built from a configuration file."""

from __future__ import annotations

import json

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo


def env_config(config: dict, which: str, num_envs: int):
    """The port's EnvConfig of the configuration's ``which`` environment (the
    reference-format YAML mapping), its contact model, ``num_envs`` envs."""
    env = cfg_mod.from_yaml(json.dumps({"environment": config[which]}))
    return env.replace(num_envs=num_envs, **config["contact"])


def ppo_config(config: dict, n_steps: int) -> ppo.PPOConfig:
    p = config["ppo"]
    return ppo.PPOConfig(learning_rate=p["learning_rate"], gamma=p["gamma"], lam=p["lam"],
                         clip_range=p["clip_range"], ent_coef=p["ent_coef"],
                         vf_coef=p["vf_coef"], max_grad_norm=p["max_grad_norm"],
                         noptepochs=p["noptepochs"], nminibatches=p["nminibatches"],
                         n_steps=n_steps, n_lstm=tuple(config["policy"]["lstm_widths"]))
