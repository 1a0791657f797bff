"""Closed-loop evaluation of a trained controller.

Port of the rollout and velocity-tracking part of ``analysis/eval.py``
(run_bp_v5.py:738-818): :func:`policy_rollout` runs the LSTM controller in
closed loop at fixed commands, one env per command, all envs in one batch;
:func:`tracking_eval` turns it into velocity-tracking statistics per command.
Each env of a batch computes exactly what a rollout of its command alone
computes. On a terrain config every env of a rollout starts on the same
stretch of the heightmap, as the JAX package's rollouts of one key do,
unless the caller gives each env its map offset.

The JAX package's rollout steps its per-env ``bp.step`` (eval.py:87). The
port steps ``step_batch`` (the fused physics kernel) where it can, and the
per-env ``step`` under hard contact or the meteorite attacks, which
``step_batch`` does not run (``scripts/hard_contact_eval.py``'s protocol:
``HardContact: true``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as tr
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix


class RolloutLog(NamedTuple):
    """Per-step traces, (T, ...) for one command or (T, B, ...) for B."""
    gc: torch.Tensor            # (T, [B,] 19)
    gv: torch.Tensor            # (T, [B,] 18)
    torque: torch.Tensor        # (T, [B,] 12) applied joint torques [Nm]
    action: torch.Tensor        # (T, [B,] 12)
    obs: torch.Tensor           # (T, [B,] 35) normalized
    reward: torch.Tensor        # (T, [B])
    done: torch.Tensor          # (T, [B])
    contact: torch.Tensor       # (T, [B,] 4)
    command: torch.Tensor       # (T, [B,] 3)
    lstm_state: torch.Tensor    # (T, [B,] S)
    joint_ref: torch.Tensor     # (T, [B,] 12)


def _fixed_command_cfg(cfg: EnvConfig) -> EnvConfig:
    """Deployment-style env: no resampling noise sources."""
    return cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0,
                       stochastic_dynamics=False)


def policy_rollout(cfg: EnvConfig, params: lstm.PolicyParams, command,
                   gen: torch.Generator, n_steps: int = 750, delay_steps: int = 0,
                   device=None, terrain_offset=None) -> RolloutLog:
    """Closed-loop rollout of the LSTM controller at fixed commands.

    command: (3,) for one env or (B, 3) for B envs stepped as one batch.
    ``gen`` must live on ``device`` (default ``cuda``). delay_steps > 0
    inserts an observation FIFO of that many control steps (the DelayTool
    latency experiment, run_bp_v5.py:360-365). On a terrain config all envs
    share one map offset drawn from ``gen``, or ``terrain_offset`` (B, 2)
    gives each env its own."""
    device = dev_mod.resolve(device)
    cmd = dev_mod.tensor(command, device)
    single = cmd.dim() == 1
    cmd = cmd.reshape(-1, 3)
    B = cmd.shape[0]
    if cfg.terrain and terrain_offset is None:
        terrain_offset = tr.sampled_fractal(gen, 1, cfg.terrain_z_scale, device).offset.expand(B, 2)

    state = bp.env_init(cfg, B, gen, device, terrain_offset).replace(command=cmd,
                                                                     command_filtered=cmd)
    obs = bp.observe(cfg, state)
    s_size = lstm.state_size([w.wh.shape[0] for w in params.pi_lstm])
    env_step = bp.step if cfg.hard_contact or cfg.crucial else bp.step_batch
    lstm_state = torch.zeros((B, s_size), device=device)
    no_reset = torch.zeros(B, device=device)
    cmd_n = (cmd - bp.obs_mean(cfg, device)[:3]) / bp.obs_std(cfg, device)[:3]
    buf = [obs] * max(delay_steps, 1)

    logs = {k: [] for k in RolloutLog._fields}
    for idx in range(n_steps):
        if delay_steps > 0:
            delayed, buf[idx % delay_steps] = buf[idx % delay_steps], obs
        else:
            delayed = obs
        delayed = torch.cat([cmd_n, delayed[:, 3:]], dim=-1)  # manual-mode command injection
        action, lstm_state = lstm.deterministic_action(params, delayed, lstm_state, no_reset)
        out = env_step(cfg, state.replace(command=cmd, command_filtered=cmd), action, gen)
        state, obs = out.state, out.obs
        for k, v in (("gc", state.gc), ("gv", state.gv), ("torque", state.torque_applied),
                     ("action", action), ("obs", obs), ("reward", out.reward),
                     ("done", out.done), ("contact", state.contact_filtered),
                     ("command", cmd), ("lstm_state", lstm_state),
                     ("joint_ref", state.joint_ref)):
            logs[k].append(v)
    stacked = {k: torch.stack(v) for k, v in logs.items()}
    if single:
        stacked = {k: v[:, 0] for k, v in stacked.items()}
    return RolloutLog(**stacked)


def body_velocity(log: RolloutLog) -> np.ndarray:
    """(T, [B,] 3) body-frame linear velocity from the log."""
    R = quat_to_matrix(log.gc[..., 3:7])
    return torch.einsum("...ji,...j->...i", R, log.gv[..., :3]).cpu().numpy()


def tracking_eval(cfg: EnvConfig, params, commands, gen: torch.Generator,
                  n_steps: int = 2000, skip=None, device=None):
    """Velocity-tracking error stats per command (run_bp_v5.py:738-818).

    All commands roll as one batch (on terrain, from one map offset).
    Steady-state stats use the trailing 40% of the rollout unless ``skip`` (in
    control steps) is given. Each row also counts the env's falls
    (terminations) over the whole rollout."""
    cmds = np.array([[float(vx), 0.0, 0.0] for vx in commands])
    log = policy_rollout(_fixed_command_cfg(cfg), params, cmds, gen, n_steps, device=device)
    return tracking_rows(cfg, log, commands, skip)


def tracking_rows(cfg: EnvConfig, log: RolloutLog, commands, skip=None):
    """:func:`tracking_eval`'s rows from the log of a batched rollout at the
    forward speeds ``commands``, one an env."""
    n_steps = log.gc.shape[0]
    cmds = np.array([[float(vx), 0.0, 0.0] for vx in commands])
    vb = body_velocity(log)[skip if skip is not None else int(n_steps * 0.6):]  # (T', B, 3)
    falls = log.done.sum(dim=0).cpu().numpy()
    sign = -1.0 if cfg.wildcat else 1.0
    rows = []
    for b, vx in enumerate(cmds[:, 0]):
        v = vb[:, b, 0]
        err = sign * v - vx
        rows.append({"command": float(vx), "v_mean": float((sign * v).mean()),
                     "v_std": float(v.std()), "err_mean": float(err.mean()),
                     "err_std": float(err.std()), "falls": int(falls[b])})
    return rows
