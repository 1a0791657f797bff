"""Control-sequence parity of the trot-MPCs against the bp5 policy.

Port of ``analysis/parity.py``: run the bp5 LSTM controller in closed loop
(through the port's ``policy_rollout``, so through the LSTM and physics
kernels on the card), take a mid-gait state, solve a trot-MPC from the same
state, command and gait clock, and report the mean absolute error between the
two normalized control sequences over the horizon: ``mpc_vs_bp5`` for the
whole-body iLQR (``mpc/trot.solve``, with its torque-space comparison through
the shared PD law), ``srb_vs_bp5`` for the convex SRB trot-MPC.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb, trot
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl


class ParityResult(NamedTuple):
    mae: float                  # mean |u_mpc - u_bp5| over horizon x 12
    torque_mae: float           # same in torque space, normalized by the limits
    bp5_actions: np.ndarray     # (T, 12)
    mpc_actions: np.ndarray     # (T, 12)


def mpc_vs_bp5(cfg: EnvConfig, params, command_vx: float = 1.0, horizon: int = 50,
               warmup: int = 200, mpc_cfg: trot.MPCConfig | None = None,
               n_steps: int | None = None, device=None) -> ParityResult:
    """The whole-body iLQR plan (``trot.solve`` of one problem; the default
    ``MPCConfig(horizon)``: 8 iterations with forward-mode AD Jacobians) from
    the policy's state at ``warmup - 1`` against the policy's next actions;
    ``torque_mae`` compares the PD-law torques of the plan's trajectory and
    of the policy's, each over the joint torque limits."""
    device = dev_mod.resolve(device)
    cfg = ev._fixed_command_cfg(cfg)
    mpc_cfg = mpc_cfg or trot.MPCConfig(horizon=horizon)
    T = mpc_cfg.horizon
    command = np.array([command_vx, 0.0, 0.0], np.float32)
    log = ev.policy_rollout(cfg, params, command, torch.Generator(device=device).manual_seed(0),
                            n_steps or (warmup + T + 1), device=device)
    t0 = dev_mod.tensor([warmup * cfg.control_dt], device)   # gait clock of the next action
    prob = trot.make_problem(cfg, log.gc[warmup - 1][None], log.gv[warmup - 1][None],
                             dev_mod.tensor(command[None], device), t0, T)
    res = trot.solve(cfg, mpc_cfg, mdl.nominal_params(cfg, device), prob)

    bp5_u = log.action[warmup:warmup + T].cpu().numpy()
    mpc_u = np.clip(res.us[0].cpu().numpy(), -1.0, 1.0)
    # torque space through the shared PD law, on the plan's own trajectory
    stand = mdl.stand_gc(cfg.abad)[7:].astype(np.float32)
    xs = res.xs[0].cpu().numpy()
    tau_mpc = cfg.stiffness * (mpc_u + stand - xs[:-1, 7:19]) - cfg.damping * xs[:-1, 25:]
    q_bp5 = log.gc[warmup:warmup + T, 7:].cpu().numpy()
    qd_bp5 = log.gv[warmup:warmup + T, 6:].cpu().numpy()
    tau_bp5 = cfg.stiffness * (bp5_u + stand - q_bp5) - cfg.damping * qd_bp5
    lim = mdl.TORQUE_LIMIT_J.astype(np.float32)
    return ParityResult(mae=float(np.abs(mpc_u - bp5_u).mean()),
                        torque_mae=float((np.abs(tau_mpc - tau_bp5) / lim).mean()),
                        bp5_actions=bp5_u, mpc_actions=mpc_u)


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
