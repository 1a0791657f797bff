"""Control-sequence parity of the SRB trot-MPC against the bp5 policy.

Port of ``analysis/parity.srb_vs_bp5``: run the bp5 LSTM controller in closed
loop (through the port's ``policy_rollout``, so through the LSTM and physics
kernels on the card), take a mid-gait state, solve the SRB trot-MPC from the
same state, command and gait clock, and report the mean absolute error between
the two normalized control sequences over the horizon. ``mpc_vs_bp5`` (the
whole-body iLQR) waits for it (ROADMAP.md, Queue 1: whole-body iLQR).
"""

from __future__ import annotations

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb


def srb_vs_bp5(cfg: EnvConfig, params, command_vx: float = 1.0, horizon: int = 50,
               warmup: int = 200, device=None) -> dict:
    """``mae`` over horizon x 12, and split by the scheduled stance/swing of
    each leg (``mae_stance``, ``mae_swing``): the SRB swing targets are the
    imitation reference itself, so the swing MAE isolates how far the policy
    strays from it. Also the two (horizon, 12) action arrays."""
    device = dev_mod.resolve(device)
    cfg = ev._fixed_command_cfg(cfg)
    command = np.array([command_vx, 0.0, 0.0], np.float32)
    log = ev.policy_rollout(cfg, params, command, torch.Generator(device=device).manual_seed(0),
                            warmup + horizon + 1, device=device)
    t0 = dev_mod.tensor([warmup * cfg.control_dt], device)   # gait clock of the next action
    cmd = dev_mod.tensor(command[None], device)
    prob = srb.make_problem(cfg, log.gc[warmup - 1][None], log.gv[warmup - 1][None], cmd, t0)
    res = srb.solve(cfg, srb.SRBConfig(horizon=horizon), prob)

    bp5_u = log.action[warmup:warmup + horizon].cpu().numpy()
    srb_u = np.clip(res.us[0].cpu().numpy(), -1.0, 1.0)
    ts = t0 + dev_mod.tensor([i * cfg.control_dt for i in range(horizon)], device)
    mask = np.repeat(srb.stance_mask(cfg, ts).cpu().numpy(), 3, axis=1)   # (T,12)
    diff = np.abs(srb_u - bp5_u)
    return {"mae": float(diff.mean()), "mae_stance": float(diff[mask > 0.5].mean()),
            "mae_swing": float(diff[mask < 0.5].mean()), "srb_actions": srb_u,
            "bp5_actions": bp5_u}
