"""Receding-horizon MPC control in the BlackPanther env (closed loop).

Port of ``mpc/runtime.py``. The SRB loop (:func:`mpc_rollout`): at every
control step the current generalized state becomes an
:class:`..mpc.srb.SRBProblem`, one TV-LQR sweep produces the force plan, and
the first knot is applied, either as normalized PD targets or, with
``torque_control``, as GRF-mapped stance torques on top of PD swing tracking
(the Convert2Torque inputs of :func:`..envs.blackpanther.step_batch`, which the
fused physics kernel takes). The whole-body loop (:func:`wb_mpc_rollout` and
its chunked and fleet forms): at every control step a
:class:`..mpc.trot.TrotProblem` from the current state, a short iLQR solve
over the dense MPC model warm-started from the previous plan shifted by one
knot, and the first knot's control as the action.

Each loop is a Python loop over the control steps; commands that share one
schedule step as one batch of envs, each env computing what a rollout of its
command alone computes, and the env step is ``step_batch``: one launch of the
fused physics kernel a control step on the card. (The JAX package's loops step
the per-env ``bp.step``; ROADMAP.md Queue 3.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr, srb, trot
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix


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


@profiling.span("mpc.rollout")
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
        profiling.set_step(i)
        with profiling.span("mpc.step"):
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
            with profiling.span("mpc.log"):
                for dst, src in ((log.gc, state.gc), (log.gv, state.gv), (log.action, action),
                                 (log.reward, out.reward), (log.done, out.done),
                                 (log.solve_cost, res.cost), (log.forces0, res.forces[:, 0]),
                                 (log.torque, state.torque_applied)):
                    dst[i] = src
    profiling.set_step(None)
    if single:
        log = MPCRolloutLog(*(x[:, 0] for x in log))
    return log


# --- whole-body receding-horizon iLQR ------------------------------------------

class WBMPCRolloutLog(NamedTuple):
    """Per-step traces of the whole-body loop: (T, ...) for one command, (T,
    B, ...) for B; (B, T, ...) from :func:`wb_mpc_rollout_batch`."""
    gc: torch.Tensor          # 19
    gv: torch.Tensor          # 18
    action: torch.Tensor      # 12 applied normalized PD targets
    reward: torch.Tensor
    done: torch.Tensor
    solve_cost: torch.Tensor  # iLQR cost of each (warm-started) plan


def wb_speed_schedule(cfg: EnvConfig, vx: float):
    """The JAX package's speed-scheduled whole-body configuration (its
    round-5 table): T = 0.20 s below 2.5 m/s and T = 0.14 s below 3.5, both
    at horizon 16; T = 0.12 s, lam = 0.44 and horizon 24 from 3.5 m/s. Two
    warm-started iterations a control step, 2 model substeps, 4 knots
    linearized at a time by the frozen linearizer, 4 step sizes.
    Returns (env_cfg, MPCConfig) for :func:`wb_mpc_rollout` (the JAX package
    runs rollouts beyond ~1200 steps through :func:`wb_mpc_rollout_chunked`)."""
    env_cfg = cfg.replace(crucial=False, terrain=False)
    if vx >= 3.5:
        env_cfg = env_cfg.replace(period=0.12, lam=0.44)
        horizon = 24
    else:
        env_cfg = env_cfg.replace(period=0.14 if vx >= 2.5 else 0.20)
        horizon = 16
    mpc_cfg = trot.MPCConfig(horizon=horizon, n_iter=2, model_substeps=2, linearize_chunk=4,
                             n_alphas=4, relin_every=1, linearizer="frozen")
    return env_cfg, mpc_cfg


def _make_wb_step(cfg: EnvConfig, mpc_cfg: trot.MPCConfig, command: torch.Tensor,
                  raibert_gain: float, terrain):
    """One control step of B envs, ``step(state, us_prev, gen) -> (state, us,
    log fields)``: the TrotProblem at the current state and gait clock, the
    iLQR solve over the dense MPC model warm-started from the previous plan
    shifted by one knot (the tail control repeated), the first knot's control
    clipped to [-1, 1] as the env step's action. The model and its frozen
    linearizer are built once, here, so every step of a rollout replays the
    linearizer's CUDA graph captured at its first (``ilqr.Replayed``).
    ``terrain``: None (the flat model) or the envs' own SampledTerrain."""
    params = mdl.nominal_params(cfg, command.device)
    dynamics = trot.make_dynamics(cfg, mpc_cfg, params, terrain)
    lin = trot.make_linearize_fn(cfg, mpc_cfg, params, terrain)
    linearize_fn = None if lin is None else ilqr.Replayed(lin)

    def step(state, us_prev, gen):
        xy_shift = None
        if raibert_gain != 0.0:
            R = quat_to_matrix(state.gc[:, 3:7])
            v_body = (R.transpose(-1, -2) @ state.gv[:, :3, None])[..., 0]
            xy_shift = raibert_gain * (v_body[:, :2] - command[:, :2])
        prob = trot.make_problem(cfg, state.gc, state.gv, command, state.current_time,
                                 mpc_cfg.horizon, xy_shift)
        u_init = torch.cat([us_prev[:, 1:], us_prev[:, -1:]], dim=1)
        res = ilqr.solve(dynamics, *trot.cost_fns(cfg, mpc_cfg, prob), prob.x0, u_init,
                         n_iter=mpc_cfg.n_iter, linearize_chunk=mpc_cfg.linearize_chunk,
                         n_alphas=mpc_cfg.n_alphas, relin_every=mpc_cfg.relin_every,
                         linearize_fn=linearize_fn)
        action = torch.clamp(res.us[:, 0], -1.0, 1.0)
        out = bp.step_batch(cfg, state.replace(command=command, command_filtered=command),
                            action, gen)
        return out.state, res.us, (out.state.gc, out.state.gv, action, out.reward, out.done,
                                   res.cost)

    return step


def _wb_segments(cfg: EnvConfig, mpc_cfg: trot.MPCConfig, command, gen: torch.Generator,
                 n_steps: int, chunk: int, raibert_gain: float, terrain_model: bool, device,
                 terrain_offset):
    """Yields the (n, B, ...) logs of consecutive segments of at most
    ``chunk`` control steps of one rollout (the last one shortened to land on
    ``n_steps``). The first warm start is zeros, as in the JAX package."""
    cfg = cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0, stochastic_dynamics=False)
    cmd = dev_mod.tensor(command, device).reshape(-1, 3)
    B = cmd.shape[0]
    state = bp.env_init(cfg, B, gen, device, terrain_offset=terrain_offset)
    state = state.replace(command=cmd, command_filtered=cmd)
    us = torch.zeros((B, mpc_cfg.horizon, 12), dtype=dev_mod.DTYPE, device=device)
    step = _make_wb_step(cfg, mpc_cfg, cmd, raibert_gain,
                         state.terrain if terrain_model else None)
    done = 0
    while done < n_steps:
        n = min(chunk, n_steps - done)

        def buf(*shape, dtype=dev_mod.DTYPE):
            return torch.empty((n, B) + shape, dtype=dtype, device=device)
        log = WBMPCRolloutLog(gc=buf(19), gv=buf(18), action=buf(12), reward=buf(),
                              done=buf(dtype=torch.bool), solve_cost=buf())
        for i in range(n):
            state, us, fields = step(state, us, gen)
            for dst, src in zip(log, fields):
                dst[i] = src
        done += n
        yield log


def wb_mpc_rollout(cfg: EnvConfig, mpc_cfg: trot.MPCConfig, command, gen: torch.Generator,
                   n_steps: int = 500, raibert_gain: float = 0.0, terrain_model: bool = False,
                   device=None, terrain_offset=None) -> WBMPCRolloutLog:
    """Closed-loop receding-horizon whole-body iLQR control at fixed commands.

    command: (3,) for one env or (B, 3) for B envs stepped as one batch
    (fields (T, ...) or (T, B, ...)). ``gen`` must live on ``device`` (default
    ``cuda``). Each control step warm-starts ``mpc_cfg.n_iter`` iterations
    from the previous plan shifted by one knot: each problem differs from the
    last by one control step.

    ``raibert_gain`` > 0 shifts the gait reference's touchdown footholds by
    gain * (v_body - v_cmd) in the body xy plane (trot.make_problem); the
    JAX package measured every gain > 0 as harmful at cmd 5, so 0.0 is its
    production setting. The MPC model uses the nominal robot and flat
    ground, or with ``terrain_model`` the envs' own heightmap (a terrain
    config; ``terrain_offset`` (B, 2) gives the envs' map offsets, else they
    are drawn from ``gen``)."""
    device = dev_mod.resolve(device)
    (log,) = _wb_segments(cfg, mpc_cfg, command, gen, n_steps, n_steps, raibert_gain,
                          terrain_model, device, terrain_offset)
    if np.ndim(command) == 1:
        log = WBMPCRolloutLog(*(x[:, 0] for x in log))
    return log


def wb_mpc_rollout_chunked(cfg: EnvConfig, mpc_cfg: trot.MPCConfig, command,
                           gen: torch.Generator, n_steps: int = 2500, chunk: int = 500,
                           raibert_gain: float = 0.0, terrain_model: bool = False, device=None,
                           terrain_offset=None) -> WBMPCRolloutLog:
    """:func:`wb_mpc_rollout` in segments of at most ``chunk`` control steps,
    each segment's logs moved to the host before the next starts, so the
    device holds one segment's logs. The (env state, plan) carry and the
    step function go on unchanged across segments, so the physics is bit for
    bit the single-segment rollout's. Fields come back as numpy arrays."""
    device = dev_mod.resolve(device)
    pieces = [WBMPCRolloutLog(*(x.cpu().numpy() for x in log)) for log in _wb_segments(
        cfg, mpc_cfg, command, gen, n_steps, chunk, raibert_gain, terrain_model, device,
        terrain_offset)]
    log = WBMPCRolloutLog(*(np.concatenate(f) for f in zip(*pieces)))
    if np.ndim(command) == 1:
        log = WBMPCRolloutLog(*(x[:, 0] for x in log))
    return log


def wb_mpc_rollout_batch(cfg: EnvConfig, mpc_cfg: trot.MPCConfig, commands,
                         gen: torch.Generator, n_steps: int = 500, raibert_gain: float = 0.0,
                         device=None) -> WBMPCRolloutLog:
    """A fleet of whole-body receding-horizon controllers stepped in lock-step:
    commands (B, 3); every field (B, n_steps, ...), as the JAX package's
    ``vmap`` over robots gives them. Each robot computes what a rollout of
    its command alone computes."""
    device = dev_mod.resolve(device)
    (log,) = _wb_segments(cfg, mpc_cfg, commands, gen, n_steps, n_steps, raibert_gain, False,
                          device, None)
    return WBMPCRolloutLog(*(x.transpose(0, 1) for x in log))
