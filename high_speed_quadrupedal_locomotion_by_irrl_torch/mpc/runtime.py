"""Receding-horizon SRB-MPC control in the BlackPanther env (closed loop).

Port of the SRB part of ``mpc/runtime.py``: at every control step the current
generalized state becomes an :class:`..mpc.srb.SRBProblem`, one TV-LQR sweep
produces the force plan, and the first knot is applied, either as normalized
PD targets or, with ``torque_control``, as GRF-mapped stance torques on top
of PD swing tracking (the Convert2Torque inputs of
:func:`..envs.blackpanther.step_batch`, which the fused physics kernel takes).
The loop is a Python loop over the control steps; commands that share one
schedule step as one batch of envs, each env computing what a rollout of its
command alone computes. The whole-body iLQR loops (``wb_*``) are not ported
yet (ROADMAP.md, Queue 1: whole-body iLQR).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait


class MPCRolloutLog(NamedTuple):
    """Per-step traces, (T, ...) for one command or (T, B, ...) for B."""
    gc: torch.Tensor          # (T, [B,] 19)
    gv: torch.Tensor          # (T, [B,] 18)
    action: torch.Tensor      # (T, [B,] 12) applied normalized PD targets
    reward: torch.Tensor      # (T, [B])
    done: torch.Tensor        # (T, [B])
    solve_cost: torch.Tensor  # (T, [B]) SRB tracking cost of each plan
    forces0: torch.Tensor     # (T, [B,] 4, 3) first-knot GRF plan (world frame)
    torque: torch.Tensor      # (T, [B,] 12) applied joint torques


def high_speed_setup(cfg: EnvConfig):
    """The calibrated high-speed closed-loop configuration of the JAX package:
    Convert2Torque stance feedforward on top of full PD, the touchdown-matched
    gait profile, 1.3x sweep pacing and the capped-impulse stiction contact.
    Returns (env_cfg, SRBConfig, mpc_rollout kwargs)."""
    env_cfg = cfg.replace(crucial=False, terrain=False, contact_impulse_mass=2.0)
    scfg = srb.SRBConfig(horizon=16, fz_max=250.0, touchdown_match=True, sweep_gain=1.3)
    kwargs = dict(torque_control=True, stance_pd=1.0, swing_pd=1.0)
    return env_cfg, scfg, kwargs


def speed_schedule(cfg: EnvConfig, vx: float):
    """Speed-scheduled configuration: high_speed_setup below 3.5 m/s, a
    T = 0.12 s / lam = 0.42 trot from 3.5 m/s and a flight-phase trot
    (lam = 0.35) from 4.5 m/s. Returns (env_cfg, SRBConfig, mpc_rollout kwargs)."""
    env_cfg, scfg, kwargs = high_speed_setup(cfg)
    if vx >= 4.5:
        env_cfg = env_cfg.replace(period=0.12, lam=0.35, stand_height=0.30)
    elif vx >= 3.5:
        env_cfg = env_cfg.replace(period=0.12, lam=0.42, stand_height=0.30)
    return env_cfg, scfg, kwargs


def mpc_rollout(cfg: EnvConfig, scfg: srb.SRBConfig, command, gen: torch.Generator,
                n_steps: int = 500, torque_control: bool = False, stance_pd: float = 0.0,
                swing_pd: float = 1.0, device=None) -> MPCRolloutLog:
    """Closed-loop receding-horizon SRB-MPC rollout at fixed commands.

    command: (3,) for one env or (B, 3) for B envs stepped as one batch under
    one schedule. ``gen`` must live on ``device`` (default ``cuda``).
    ``torque_control=True`` drives stance legs with GRF-mapped joint torques
    (srb.grf_to_torque) while swing legs PD-track the gait reference on the
    schedule the solver planned for (srb.sweep_command)."""
    device = dev_mod.resolve(device)
    cfg = cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0, stochastic_dynamics=False)
    cmd = dev_mod.tensor(command, device)
    single = cmd.dim() == 1
    cmd = cmd.reshape(-1, 3)
    B = cmd.shape[0]
    state = bp.env_init(cfg, B, gen, device).replace(command=cmd, command_filtered=cmd)
    stand = dev_mod.tensor(mdl.stand_gc(cfg.abad)[7:], device)

    def buf(*shape, dtype=dev_mod.DTYPE):
        return torch.empty((n_steps, B) + shape, dtype=dtype, device=device)
    log = MPCRolloutLog(gc=buf(19), gv=buf(18), action=buf(12), reward=buf(),
                        done=buf(dtype=torch.bool), solve_cost=buf(), forces0=buf(4, 3),
                        torque=buf(12))
    for i in range(n_steps):
        prob = srb.make_problem(cfg, state.gc, state.gv, cmd, state.current_time)
        res = srb.solve(cfg, scfg, prob, controls=not torque_control)
        st = state.replace(command=cmd, command_filtered=cmd)
        if torque_control:
            sm0 = srb.stance_mask(cfg, state.current_time)
            tau_ff, pd_scale = srb.grf_to_torque(cfg, state.gc, res.forces[:, 0], sm0,
                                                 stance_pd, swing_pd)
            xy_shift = scfg.raibert_gain * (prob.v_meas - cmd[:, :2])
            # swing tracking follows the schedule the solver planned stance forces for
            sched_cmd = srb.sweep_command(cfg, scfg, prob)
            q_ref = gait.gait_reference(cfg, sched_cmd, state.current_time, xy_shift,
                                        scfg.touchdown_match).joint_ref
            action = torch.clamp(q_ref - stand, -1.0, 1.0)
            out = bp.step_batch(cfg, st, action, gen, tau_ff=tau_ff, pd_scale=pd_scale)
        else:
            action = torch.clamp(res.us[:, 0], -1.0, 1.0)
            out = bp.step_batch(cfg, st, action, gen)
        state = out.state
        for dst, src in ((log.gc, state.gc), (log.gv, state.gv), (log.action, action),
                         (log.reward, out.reward), (log.done, out.done),
                         (log.solve_cost, res.cost), (log.forces0, res.forces[:, 0]),
                         (log.torque, state.torque_applied)):
            dst[i] = src
    if single:
        log = MPCRolloutLog(*(x[:, 0] for x in log))
    return log
