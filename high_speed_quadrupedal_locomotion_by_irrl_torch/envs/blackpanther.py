"""The BlackPanther trot-imitation MDP, batched over a leading env axis.

Port of ``envs/blackpanther.py`` (the reference's
``BlackPanther_V55/Environment.hpp``): reset, the PD-to-torque pipeline with
the speed-dependent motor envelope (:mod:`..ops.pd_torque`) and 8 physics
substeps a control step, observation, the 8-term DeepMimic reward,
termination, online references, the branchless auto-reset and the
meteorite-attack curriculum (``cfg.crucial``). Every field of
:class:`EnvState` has a leading env axis; a single env is a batch of one.
Randomness comes from a ``torch.Generator`` that lives on the state's device.

Two control steps share everything but the substeps, and draw from the
generator in the same order:

* :func:`step_batch`, the batch-in-lanes path: the substeps fused into one
  call of the hand-written CUDA kernel (:func:`..ops.phys_cuda.control_step`),
  compliant contact with a vertical normal on terrain, and on the card the
  rest of the step replayed as one CUDA graph (:mod:`.post_graph`);
* :func:`step`, the counterpart of JAX's ``vmap(step)``: the dense per-env
  physics of :mod:`..phys.dynamics` substep by substep (plain PyTorch, as JAX
  computes it outside any Pallas kernel), with the terrain's own normal, hard
  toe contact (``cfg.hard_contact``) and the attack spheres' wrenches, which
  ``step_batch`` refuses as JAX's does.

On a terrain config (``cfg.terrain``) every env stands on its own stretch of
ground (:mod:`..phys.terrain`): the shared sampled heightmap at its own map
offset, or with ``cfg.terrain_sampled=False`` the analytic fractal of its own
seed. It spawns above the ground under it, and the physics looks the ground
up under every toe and base corner.

With a RefTraj table (``ref_table``, (N, 30), :mod:`.reftraj`) and
``cfg.manual_traj`` off, the references, the filtered command and the phase
observation come from the table row of each env's frame index instead of
the online gait generator; the table is one tensor on the state's device,
shared by every env.

Reference quirks kept as in the JAX package (the shipped policies were
trained against them): the torque smoothing mixes 1% of the *normalized*
torque of the previous control step; the "stop" command bucket is a no-op;
Vx_min stays 0; reward mimic targets lag the state by one control step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import post_graph
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import contact as ct
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import spatial as sp
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as tr
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix

OBS_DIM = 35
ACT_DIM = 12
_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class EnvState:
    """Batched env state; every tensor has a leading (B,) axis."""
    # physics
    gc: torch.Tensor                 # (B, 19)
    gv: torch.Tensor                 # (B, 18)
    params: mdl.RobotParams          # per-env dynamics (fixed across auto-resets)
    terrain: tr.SampledTerrain | tr.TerrainParams | None  # per-env (cfg.terrain), else None
    # control pipeline
    ptarget_last: torch.Tensor       # (B, 12)
    torque_norm_last: torch.Tensor   # (B, 12) normalized torque (see module notes)
    torque_applied: torch.Tensor     # (B, 12) last substep's clamped torque [Nm]
    base_wrench: torch.Tensor        # (B, 6) active disturbance wrench [f; n_base]
    # references
    command: torch.Tensor            # (B, 3) raw command (persists across resets)
    command_filtered: torch.Tensor   # (B, 3)
    joint_ref: torch.Tensor          # (B, 12)
    joint_ref_last: torch.Tensor     # (B, 12)
    joint_dot_ref: torch.Tensor      # (B, 12)
    ee_ref: torch.Tensor             # (B, 12)
    # timing
    current_time: torch.Tensor       # (B,) time of the NEXT state
    frame_idx: torch.Tensor          # (B,) int32
    # contact bookkeeping
    contact_filtered: torch.Tensor   # (B, 4)
    contact_force_norm: torch.Tensor  # (B, 4)
    contact_vel_norm: torch.Tensor   # (B, 4)
    # observation
    obs_double: torch.Tensor         # (B, 35) unnormalized obs (with noise)
    obs_last: torch.Tensor           # (B, 35) previous obs (ObsFilter)
    # episode bookkeeping
    done: torch.Tensor               # (B,) bool — this step terminated
    ep_return: torch.Tensor          # (B,)
    ep_len: torch.Tensor             # (B,) int32
    reward_terms: torch.Tensor       # (B, 8) [EE, BodyPos, BodyAtti, J, Jdot, Vel, Torque, Contact]
    # meteorite-attack curriculum (crucial learning, Environment.hpp:815-861);
    # C = 0 spheres when cfg.crucial is off
    cube_pos: torch.Tensor           # (B, C, 3)
    cube_vel: torch.Tensor           # (B, C, 3)
    cube_radius: torch.Tensor        # (B,)
    cube_mass: torch.Tensor          # (B,)
    cube_active: torch.Tensor        # (B,) bool: the spheres are dynamic (attacking)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class StepOut(NamedTuple):
    state: EnvState
    obs: torch.Tensor       # (B, 35) normalized
    reward: torch.Tensor    # (B,)
    done: torch.Tensor      # (B,) bool
    info: dict


# --- constants per (config, device) --------------------------------------------

class _Consts(NamedTuple):
    obs_mean: torch.Tensor      # (35,)
    obs_std: torch.Tensor       # (35,)
    action_mean: torch.Tensor   # (12,)
    torque_limit: torch.Tensor  # (12,)
    phase_offsets: torch.Tensor  # (4,)
    init_joint_ref: torch.Tensor  # (12,)
    stand_gc: torch.Tensor      # (19,)
    cube_ring: torch.Tensor     # (C, 3) attack-sphere spawn ring around the robot
    box_half: torch.Tensor      # (3,) base collision box half-extents
    gravity: torch.Tensor       # (3,)


def _obs_mean_np(cfg: EnvConfig) -> np.ndarray:
    return np.concatenate([
        [(cfg.vx_max + cfg.vx_min) / 2, (cfg.vy_max + cfg.vy_min) / 2,
         (cfg.omega_max + cfg.omega_min) / 2],
        np.zeros(2), mdl.stand_gc(cfg.abad)[7:], np.zeros(12), [0.0, 0.0, 1.0], np.zeros(3)])


def _obs_std_np() -> np.ndarray:
    return np.concatenate([np.ones(3), np.ones(2), np.ones(12), np.tile([5.0, 35.0, 40.0], 4),
                           np.full(3, 0.7), np.full(3, 3.0)])


@functools.cache
def _consts(cfg: EnvConfig, device: torch.device) -> _Consts:
    """Read-only constant tensors, made once per config and device so the
    step issues no host-to-device copies; kept for the process's life, since
    the step's CUDA graphs (:mod:`.post_graph`) read them by address."""
    t = lambda x: dev_mod.tensor(x, device)  # noqa: E731
    return _Consts(
        obs_mean=t(_obs_mean_np(cfg)), obs_std=t(_obs_std_np()),
        action_mean=t(mdl.stand_gc(cfg.abad)[7:]),
        torque_limit=t(mdl.TORQUE_LIMIT_J),
        phase_offsets=t(cfg.phase_offsets),
        init_joint_ref=t(np.array([-1.0, 0, 0, 1.0, 0, 0, -1.0, 0, 0, 1.0, 0, 0]) * cfg.abad),
        stand_gc=t(mdl.stand_gc(cfg.abad)),
        cube_ring=t(_circle_place(cfg.cube_place_radius, cfg.num_cube if cfg.crucial else 0)),
        box_half=t(mdl.BODY_BOX_HALF), gravity=t([0.0, 0.0, -9.81]))


# --- observation statistics (Environment.hpp:374-393) -----------------------

def obs_mean(cfg: EnvConfig, device=None) -> torch.Tensor:
    return _consts(cfg, dev_mod.resolve(device)).obs_mean


def obs_std(cfg: EnvConfig, device=None) -> torch.Tensor:
    return _consts(cfg, dev_mod.resolve(device)).obs_std


def action_mean(cfg: EnvConfig, device=None) -> torch.Tensor:
    return _consts(cfg, dev_mod.resolve(device)).action_mean


# --- PD torque pipeline: the functions live in ops/pd_torque.py, shared with
# the physics wrapper; these keep the JAX package's names and signatures -------

real_torque = pd_torque.real_torque


def torque_clamp(cfg: EnvConfig, torque: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Speed-dependent motor-envelope clamp on the (..., 12) joint torques
    (Environment.hpp:1273-1312)."""
    return pd_torque.torque_clamp(pd_torque.from_config(cfg), torque, qd)


# --- phase-shaped contact windows (Environment.hpp:118-156) ------------------

def smooth_function(phase: torch.Tensor, slope: float, lam: float) -> torch.Tensor:
    ph = torch.remainder(phase, 1.0)
    t = torch.where(ph < lam,
                    torch.sin(ph / lam * _TWO_PI) * slope + 0.5,
                    -torch.sin((ph - lam) / (1.0 - lam) * _TWO_PI) * slope + 0.5)
    return torch.clamp(t, 0.0, 1.0)


def smooth_function2(phase: torch.Tensor, slope: float, lam: float) -> torch.Tensor:
    ph = torch.remainder(phase, 1.0)
    t = torch.where(ph < lam,
                    torch.sin(ph / lam * _TWO_PI) * slope + 0.5,
                    -torch.sin((ph - lam) / (1.0 - lam) * _TWO_PI) * slope + 0.5)
    return torch.where(t > 1.0, torch.zeros_like(t),
                       torch.where(t < 0.0, torch.ones_like(t), 1.0 - t))


def _uniform(gen: torch.Generator, shape, device, lo=-1.0, hi=1.0) -> torch.Tensor:
    return lo + (hi - lo) * dev_mod.rand(gen, shape, device)


# --- command resampling (command_obs_update, Environment.hpp:1010-1109) ------

def _resample_command(cfg: EnvConfig, gen: torch.Generator, command: torch.Tensor,
                      force: bool) -> torch.Tensor:
    """command (B, 3); force resamples every env (the reset call)."""
    r = _uniform(gen, (command.shape[0], 3), command.device, 0.0, 1.0)
    trigger = r[:, 0] < 0.5 / (cfg.max_time / cfg.control_dt)
    if force:
        trigger = torch.ones_like(trigger)
    bucket, u = r[:, 1], r[:, 2]
    # 0.2<u<=0.7: vx;  0.7<u<=0.85: vy;  u>0.85: omega;  u<=0.2: no-op (ref bug kept)
    new = torch.stack([
        torch.where((bucket > 0.2) & (bucket <= 0.7),
                    u * cfg.vx_max + (1 - u) * cfg.vx_min, command[:, 0]),
        torch.where((bucket > 0.7) & (bucket <= 0.85),
                    u * cfg.vy_max + (1 - u) * cfg.vy_min, command[:, 1]),
        torch.where(bucket > 0.85,
                    u * cfg.omega_max + (1 - u) * cfg.omega_min, command[:, 2]),
    ], dim=-1)
    return torch.where(trigger[:, None], new, command)


class RefUpdate(NamedTuple):
    command: torch.Tensor
    command_filtered: torch.Tensor
    joint_ref: torch.Tensor
    joint_dot_ref: torch.Tensor
    ee_ref: torch.Tensor
    phase: torch.Tensor | None   # (B, 2) table-provided phase obs, or None


def _uses_table(cfg: EnvConfig, ref_table) -> bool:
    return ref_table is not None and not cfg.manual_traj


def _table_rows(ref_table: torch.Tensor, frame_idx: torch.Tensor) -> torch.Tensor:
    """Each env's (B, 30) table row at its frame index, clipped to the table."""
    return ref_table[frame_idx.clamp(0, ref_table.shape[0] - 1).long()]


def _update_references(cfg: EnvConfig, gen: torch.Generator, command: torch.Tensor,
                       command_filtered: torch.Tensor, joint_ref_prev: torch.Tensor,
                       joint_dot_prev: torch.Tensor, t: torch.Tensor, frame_idx: torch.Tensor,
                       is_reset: bool, ref_table: torch.Tensor | None = None) -> RefUpdate:
    """command_obs_update(flag_reset): online Bezier references (ManualTraj,
    Environment.hpp:1024-1099) or the RefTraj table row of ``frame_idx``
    (:1100-1107 with gait_generator :1664-1682: theta 0:12 | theta_dot 12:24 |
    z 24 | phase 25:27 | cmd 27:30); references frozen in manual mode."""
    if cfg.manual:
        # manual mode: commands injected by the caller; references frozen
        return RefUpdate(command, command_filtered, joint_ref_prev, joint_dot_prev,
                         torch.zeros_like(joint_ref_prev), None)
    if _uses_table(cfg, ref_table):
        row = _table_rows(ref_table, frame_idx)
        return RefUpdate(command=command, command_filtered=row[:, 27:30],
                         joint_ref=row[:, 0:12], joint_dot_ref=row[:, 12:24],
                         ee_ref=torch.zeros_like(joint_ref_prev), phase=row[:, 25:27])
    command = _resample_command(cfg, gen, command, is_reset)
    if is_reset:
        command_filtered = command
    else:
        command_filtered = (command_filtered * cfg.cmd_update_param
                            + command * (1.0 - cfg.cmd_update_param))
    ref = gait.gait_reference(cfg, command_filtered, t)
    if is_reset:
        # jointRefLast from t - dt so jointDotRef is well-defined at reset
        joint_ref_last = gait.gait_reference(cfg, command_filtered,
                                             t - cfg.control_dt).joint_ref
    else:
        joint_ref_last = joint_ref_prev
    joint_dot_ref = (ref.joint_ref - joint_ref_last) / cfg.control_dt
    return RefUpdate(command, command_filtered, ref.joint_ref, joint_dot_ref, ref.ee_ref, None)


# --- observation (updateObservation, Environment.hpp:956-1004) ---------------

def _raw_observation(cfg: EnvConfig, gen: torch.Generator, gc: torch.Tensor,
                     gv: torch.Tensor, command_filtered: torch.Tensor, t: torch.Tensor,
                     phase_override: torch.Tensor | None = None):
    """Unnormalized (B, 35) obs with sensor noise; also body-frame linear and
    angular velocities and the base rotation. Noise scaled by cfg.obs_noise = 0
    is not drawn. ``phase_override``: a RefTraj table's (B, 2) phase
    (Environment.hpp:972) instead of the gait clock's."""
    B, dev = gc.shape[0], gc.device
    nf = cfg.obs_noise
    if phase_override is not None:
        phase = phase_override
    else:
        phase = torch.stack([torch.sin(_TWO_PI * t / cfg.period),
                             torch.cos(_TWO_PI * t / cfg.period)], dim=-1)
    joints, joint_vel = gc[:, 7:], gv[:, 6:]
    R = quat_to_matrix(gc[:, 3:7])
    posture = R[:, 2, :]
    v_body = torch.einsum("bji,bj->bi", R, gv[:, :3])
    w_body = torch.einsum("bji,bj->bi", R, gv[:, 3:6])
    omega = w_body
    if nf:
        joints = joints + _uniform(gen, (B, 12), dev) * cfg.joint_noise * nf
        joint_vel = joint_vel + _uniform(gen, (B, 12), dev) * cfg.joint_velocity_noise * nf
        posture = posture + dev_mod.randn(gen, (B, 3), dev) * cfg.posture_noise_std * nf
        omega = omega + dev_mod.randn(gen, (B, 3), dev) * cfg.omega_noise_std * nf
    obs = torch.cat([command_filtered, phase, joints, joint_vel, posture, omega], dim=-1)
    return obs, v_body, w_body, R


def normalize_obs(cfg: EnvConfig, obs_double: torch.Tensor) -> torch.Tensor:
    c = _consts(cfg, obs_double.device)
    return (obs_double - c.obs_mean) / c.obs_std


def observe(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    return normalize_obs(cfg, state.obs_double)


# --- reward (DeepMimicRewardUpdate, Environment.hpp:1444-1548) ----------------

class _RewardOut(NamedTuple):
    total: torch.Tensor          # (B,)
    terms: torch.Tensor          # (B, 8)
    torque_norm: torch.Tensor    # (B, 12) for the next step's smoothing


def deep_mimic_reward(cfg: EnvConfig, t, gc, gv, obs_double, v_body, w_body, R, toe_pos,
                      joint_ref, joint_dot_ref, ee_ref, command_filtered, torque_applied,
                      torque_norm_last, contact_vel_norm, contact_force_norm) -> _RewardOut:
    """All arguments batched: t (B,), toe_pos (B, 4, 3), R (B, 3, 3), the
    rest (B, k) as in EnvState."""
    c = _consts(cfg, gc.device)
    B = gc.shape[0]
    ee = torch.einsum("bji,bkj->bki", R, toe_pos - gc[:, None, :3]).reshape(B, 12)
    r_ee = cfg.ee_coeff * torch.exp(-40.0 * torch.sum((ee - ee_ref) ** 2, dim=-1))

    r_h = cfg.body_pos_coeff * torch.exp(-80.0 * (gc[:, 2] - cfg.stand_height) ** 2)
    r_att = cfg.body_atti_coeff * torch.exp(-80.0 * torch.sum(obs_double[:, 29:31] ** 2, dim=-1))

    r_j = cfg.joint_mimic_coeff * 0.25 * torch.exp(
        -2.0 * torch.sum((joint_ref - gc[:, 7:]) ** 2, dim=-1))
    r_jd = cfg.joint_mimic_coeff * 0.75 * torch.exp(
        -cfg.control_dt * torch.sum((joint_dot_ref - gv[:, 6:]) ** 2, dim=-1))

    zero = torch.zeros_like(command_filtered[:, 0])
    vx_ref = -command_filtered[:, 0] if cfg.wildcat else command_filtered[:, 0]
    v_ref = torch.stack([vx_ref, command_filtered[:, 1], zero], dim=-1)
    w_ref = torch.stack([zero, zero, command_filtered[:, 2]], dim=-1)
    r_vel = (cfg.vel_keep_coeff / 2 * torch.exp(-2.0 * torch.sum((v_body - v_ref) ** 2, dim=-1))
             + cfg.vel_keep_coeff / 2 * torch.exp(
                 -2.0 * torch.sum((w_body - w_ref) ** 2, dim=-1)))

    torque_norm = torque_applied / c.torque_limit
    r_tau = (cfg.torque_coeff / 2 * torch.exp(-0.1 * torch.sum(torque_norm ** 2, dim=-1))
             + cfg.torque_coeff / 2 * torch.exp(
                 -0.1 / cfg.control_dt * torch.sum((torque_norm - torque_norm_last) ** 2,
                                                   dim=-1)))

    phase = torch.remainder(t[:, None] + c.phase_offsets * cfg.period, cfg.period) / cfg.period
    slip = 4.0 * contact_vel_norm ** 2 * smooth_function(phase, 2.0, cfg.lam)
    impact = 2.0 * (contact_force_norm / 12.5) ** 2 * smooth_function2(phase, 2.0, cfg.lam)
    r_ct = cfg.contact_coeff * torch.exp(-2.0 * torch.sum(slip + impact, dim=-1))

    terms = torch.stack([r_ee, r_h, r_att, r_j, r_jd, r_vel, r_tau, r_ct], dim=-1)
    return _RewardOut(total=torch.sum(terms, dim=-1), terms=terms, torque_norm=torque_norm)


# --- disturbances (Environment.hpp:866-940) ----------------------------------

def _force_attack(cfg: EnvConfig, gen: torch.Generator, B: int, device) -> torch.Tensor:
    """Random (B, 6) base wrench, ~2 impulses per episode when enabled (the
    reference's integer random() draw is implemented with its intended
    probability, as in the JAX package)."""
    trigger = _uniform(gen, (B,), device, 0.0, 1.0) < 2.0 * cfg.control_dt / cfg.max_time
    ff = _uniform(gen, (B, 6), device)
    zero = torch.zeros_like(ff[:, 0])
    wrench = torch.stack([zero, zero, ff[:, 2] * 2000.0, ff[:, 3] * 400.0, ff[:, 4] * 400.0,
                          zero], dim=-1)
    return torch.where(trigger[:, None], wrench, torch.zeros_like(wrench))


def _circle_place(radius: float, num: int) -> np.ndarray:
    """(num, 3) ring positions at z=1 (circle_place, Environment.hpp:61-66)."""
    ang = np.arange(num) / max(num, 1) * 2.0 * np.pi
    return np.stack([radius * np.sin(ang), radius * np.cos(ang), np.ones(num)], axis=-1)


def _cube_ring_reset(cfg: EnvConfig, gc: torch.Tensor, t: torch.Tensor):
    """Re-spawn every env's attack spheres around its robot; size and mass
    grow with episode time (meteoriteAttack reset branch,
    Environment.hpp:827-841). -> (pos (B, C, 3), vel, radius (B,), mass (B,))."""
    ring = _consts(cfg, gc.device).cube_ring
    centre = torch.stack([gc[:, 0] + 0.05, gc[:, 1], gc[:, 2]], dim=-1)
    pos = ring + centre[:, None, :]
    return pos, torch.zeros_like(pos), (t / 5.0 + 1.0) * cfg.cube_len, t / 5.0 + 0.2


SHANK_CAPSULE_RADIUS = 0.016  # visual shank mesh thickness (black_panther.urdf shank .dae)


def _sphere_robot_forces(cfg: EnvConfig, params, gc: torch.Tensor, cube_pos, cube_vel,
                         radius, mass, tp):
    """Attack-sphere contact with the ground, the base box and the four shank
    capsules (knee to toe) of every env (meteoriteAttack,
    Environment.hpp:815-861). cube_pos, cube_vel (B, C, 3); radius, mass (B,).
    Returns (sphere accelerations (B, C, 3), the reaction on the robot as
    world-origin wrenches (B, 13, 6), the per-body ``f_ext_extra`` of the
    substeps)."""
    kn, dn = 5e4, 100.0
    c = _consts(cfg, gc.device)
    # ground contact
    f_ground, _ = ct.point_contact_force(cube_pos, cube_vel, radius[:, None], tp, kn, dn, 0.6,
                                         cfg.contact_slip_vel)
    # body-box contact: closest point on the box (body frame) to the sphere's centre
    R = quat_to_matrix(gc[:, 3:7])
    rel = torch.einsum("bji,bcj->bci", R, cube_pos - gc[:, None, :3])
    closest = torch.clamp(rel, -c.box_half, c.box_half)
    delta = rel - closest
    dist = torch.linalg.vector_norm(delta, dim=-1)
    pen = torch.clamp_min(radius[:, None] - dist, 0.0)
    n_body = delta / torch.clamp_min(dist, 1e-6)[..., None]
    n_world = torch.einsum("bij,bcj->bci", R, n_body)
    f_box = (kn * pen)[..., None] * n_world              # on the sphere, world frame
    box_contact_w = gc[:, None, :3] + torch.einsum("bij,bcj->bci", R, closest)

    # shank-capsule contact: each leg's knee-to-toe segment against each sphere
    kin = dyn.fk(params, gc)
    seg_a = kin.p[:, dyn.SHANKS, :]                       # (B, 4, 3) knee anchors
    ab = kin.toe_pos - seg_a
    ab_len2 = torch.clamp_min(torch.sum(ab * ab, dim=-1), 1e-9)
    ap = cube_pos[:, :, None, :] - seg_a[:, None, :, :]   # (B, C, 4, 3)
    s = torch.clamp(torch.einsum("bcli,bli->bcl", ap, ab) / ab_len2[:, None, :], 0.0, 1.0)
    closest_seg = seg_a[:, None] + s[..., None] * ab[:, None]
    d_seg = cube_pos[:, :, None, :] - closest_seg
    dist_seg = torch.linalg.vector_norm(d_seg, dim=-1)   # (B, C, 4)
    pen_seg = torch.clamp_min(radius[:, None, None] + SHANK_CAPSULE_RADIUS - dist_seg, 0.0)
    n_seg = d_seg / torch.clamp_min(dist_seg, 1e-6)[..., None]
    f_shank = (kn * pen_seg)[..., None] * n_seg          # (B, C, 4, 3) on the sphere

    f_total = f_ground + f_box + torch.sum(f_shank, dim=2)
    acc = f_total / torch.clamp_min(mass, 1e-6)[:, None, None] + c.gravity

    # reaction wrenches on the robot (world-origin spatial forces)
    base = torch.sum(sp.force_at_point(-f_box, box_contact_w), dim=1)
    shank = torch.sum(sp.force_at_point(-f_shank, closest_seg), dim=1)      # (B, 4, 6)
    zero = torch.zeros_like(base)
    rows = [base] + [shank[:, dyn._SHANK.index(b)] if b in dyn._SHANK else zero
                     for b in range(1, mdl.NUM_BODIES)]
    return acc, torch.stack(rows, dim=1)


# --- reset --------------------------------------------------------------------

def _terrain(cfg: EnvConfig, batch: int, gen: torch.Generator, device, terrain_offset,
             terrain_seed):
    """The envs' terrain (JAX env_init, blackpanther.py:427-432): None without
    terrain; the sampled heightmap at drawn or given (batch, 2) map offsets;
    or (``cfg.terrain_sampled=False``) the analytic fractal of drawn or given
    (batch,) seeds."""
    sampled, analytic = cfg.terrain and cfg.terrain_sampled, cfg.terrain and not cfg.terrain_sampled
    where = ("the sampled heightmap" if sampled else "the analytic terrain" if analytic
             else "a config without terrain")
    if (terrain_offset is not None and not sampled) or (terrain_seed is not None and not analytic):
        raise ValueError(f"{'terrain_offset' if terrain_offset is not None else 'terrain_seed'} "
                         f"given for {where}")
    z = cfg.terrain_z_scale
    if sampled:
        if terrain_offset is None:
            return tr.sampled_fractal(gen, batch, z, device)
        return tr.at_offsets(dev_mod.tensor(terrain_offset, device).reshape(batch, 2), z)
    if analytic:
        if terrain_seed is None:
            return tr.fractal(gen, batch, z, device)
        return tr.with_seeds(dev_mod.tensor(terrain_seed, device).reshape(batch), z)
    return None


def env_init(cfg: EnvConfig, batch: int, gen: torch.Generator, device=None,
             terrain_offset: torch.Tensor | None = None,
             terrain_seed: torch.Tensor | None = None,
             ref_table: torch.Tensor | None = None) -> EnvState:
    """Construction-time state of ``batch`` envs: domain randomization, the
    terrain and the first reset (VectorizedEnvironment.hpp:172-182). ``gen``
    must live on ``device`` (default ``cuda``). On a terrain config each env
    draws its map offset (the sampled heightmap) or its seed (the analytic
    fractal) from ``gen``, unless ``terrain_offset`` (batch, 2) or
    ``terrain_seed`` (batch,) gives them. ``ref_table``: an optional (N, 30)
    RefTraj table on ``device``, shared by every env (the analog of
    VectorizedEnvironment::set_ref, :158-182)."""
    device = dev_mod.resolve(device)
    c = _consts(cfg, device)
    params = (mdl.randomize(gen, cfg, batch, device) if cfg.stochastic_dynamics
              else mdl.nominal_params(cfg, device).expand(batch))
    terrain = _terrain(cfg, batch, gen, device, terrain_offset, terrain_seed)
    z = lambda *shape: torch.zeros((batch,) + shape, device=device)  # noqa: E731
    zi = lambda: torch.zeros(batch, dtype=torch.int32, device=device)  # noqa: E731
    blank = EnvState(
        gc=c.stand_gc.expand(batch, 19).clone(), gv=z(18), params=params, terrain=terrain,
        ptarget_last=z(12), torque_norm_last=z(12), torque_applied=z(12), base_wrench=z(6),
        command=z(3), command_filtered=z(3),
        joint_ref=c.init_joint_ref.expand(batch, 12).clone(),
        joint_ref_last=c.init_joint_ref.expand(batch, 12).clone(),
        joint_dot_ref=z(12), ee_ref=z(12), current_time=z(), frame_idx=zi(),
        contact_filtered=z(4), contact_force_norm=z(4), contact_vel_norm=z(4),
        obs_double=z(OBS_DIM), obs_last=z(OBS_DIM),
        done=torch.zeros(batch, dtype=torch.bool, device=device), ep_return=z(),
        ep_len=zi(), reward_terms=z(8), cube_pos=z(c.cube_ring.shape[0], 3),
        cube_vel=z(c.cube_ring.shape[0], 3), cube_radius=torch.full_like(z(), cfg.cube_len),
        cube_mass=torch.full_like(z(), cfg.cube_mass),
        cube_active=torch.zeros(batch, dtype=torch.bool, device=device))
    return reset(cfg, blank, gen, ref_table)


def _sampling_reshape(ratio: torch.Tensor) -> torch.Tensor:
    """Density-reshaped episode-start sampling (Environment.hpp:71-81)."""
    return torch.where((ratio < 0.5) & (ratio > 0.0), ratio * 4.0 / 3.0, (2.0 * ratio + 1.0) / 3.0)


def reset(cfg: EnvConfig, state: EnvState, gen: torch.Generator,
          ref_table: torch.Tensor | None = None) -> EnvState:
    """reset() (Environment.hpp:547-635) of every env of the batch: random
    phase start, command resample, joint pose/vel perturbed +-30% around the
    gait reference, base velocity seeded from the command +-20%, random xy
    +-5 m; manual mode starts from the stand pose at rest. On terrain the base
    spawns at stand height above the ground under it. Dynamics params,
    terrain, the raw command and the last position target persist; under
    ``cfg.crucial`` the attack spheres re-spawn around the robot, at rest.
    With a RefTraj table each env starts at a frame drawn with the reference's
    density reshaping from the same uniform as its start time."""
    B, dev = state.gc.shape[0], state.gc.device
    c = _consts(cfg, dev)
    zeros = lambda *shape: torch.zeros((B,) + shape, device=dev)  # noqa: E731
    t0 = zeros() if cfg.manual else _uniform(gen, (B,), dev, 0.0, 1.0)
    frame0 = torch.zeros(B, dtype=torch.int32, device=dev)
    if _uses_table(cfg, ref_table) and not cfg.manual:
        span = ref_table.shape[0] - cfg.episode_len - 10
        frame0 = torch.clamp_min((span * _sampling_reshape(t0)).to(torch.int32), 0)

    upd = _update_references(cfg, gen, state.command, zeros(3), state.joint_ref,
                             state.joint_dot_ref, t0, frame0, is_reset=True, ref_table=ref_table)
    command, command_filtered = upd.command, upd.command_filtered

    stand = c.stand_gc.expand(B, 19)
    if cfg.manual:
        gc = stand.clone()
        gv = zeros(18)
    else:
        jp_noise, jv_noise = _uniform(gen, (B, 12), dev), _uniform(gen, (B, 12), dev)
        bv_noise = _uniform(gen, (B, 3), dev)
        q0 = upd.joint_ref * (1.0 + 0.3 * jp_noise)
        qd0 = upd.joint_dot_ref * (1.0 + 0.3 * jv_noise)
        vx = command_filtered[:, 0] * (0.2 * bv_noise[:, 0] + 1.0)
        vx = -vx if cfg.wildcat else vx
        vy = command_filtered[:, 1] * (0.2 * bv_noise[:, 1] + 1.0)
        wz = command_filtered[:, 2] * (0.2 * bv_noise[:, 2] + 1.0)
        xy = _uniform(gen, (B, 2), dev, -5.0, 5.0)
        gc = torch.cat([xy, stand[:, 2:7], q0], dim=-1)
        zero = zeros()
        gv = torch.cat([torch.stack([vx, vy, zero, zero, zero, wz], dim=-1), qd0], dim=-1)
    if cfg.terrain:  # spawn stand-height above the local ground surface
        z0 = stand[:, 2] + tr.height(state.terrain, gc[:, 0], gc[:, 1])
        gc = torch.cat([gc[:, :2], z0[:, None], gc[:, 3:]], dim=-1)

    obs, _, _, _ = _raw_observation(cfg, gen, gc, gv, command_filtered, t0, upd.phase)

    # post-obs reference regeneration (command_obs_update(false) at reset tail)
    upd2 = _update_references(cfg, gen, command, command_filtered, upd.joint_ref,
                              upd.joint_dot_ref, t0, frame0, is_reset=False, ref_table=ref_table)
    obs = torch.cat([upd2.command_filtered, obs[:, 3:]], dim=-1)

    if cfg.crucial:  # re-spawn the attack ring (meteoriteAttack(true), :608-612)
        cube_pos, cube_vel, cube_radius, cube_mass = _cube_ring_reset(cfg, gc, t0)
        state = state.replace(cube_pos=cube_pos, cube_vel=cube_vel, cube_radius=cube_radius,
                              cube_mass=cube_mass,
                              cube_active=torch.zeros(B, dtype=torch.bool, device=dev))

    return state.replace(
        gc=gc, gv=gv, torque_norm_last=zeros(12), torque_applied=zeros(12),
        base_wrench=zeros(6), command=upd2.command, command_filtered=upd2.command_filtered,
        joint_ref=upd2.joint_ref, joint_ref_last=upd2.joint_ref,
        joint_dot_ref=upd2.joint_dot_ref, ee_ref=upd2.ee_ref,
        current_time=t0 + cfg.control_dt, frame_idx=frame0 + 1,
        contact_filtered=zeros(4), contact_force_norm=zeros(4), contact_vel_norm=zeros(4),
        obs_double=obs, obs_last=obs, done=torch.zeros(B, dtype=torch.bool, device=dev),
        ep_return=zeros(), ep_len=torch.zeros(B, dtype=torch.int32, device=dev),
        reward_terms=zeros(8))


# --- step ----------------------------------------------------------------------

class _PreOut(NamedTuple):
    gc: torch.Tensor
    gv: torch.Tensor
    ptarget: torch.Tensor
    base_wrench: torch.Tensor
    cube_pos: torch.Tensor
    cube_vel: torch.Tensor
    cube_radius: torch.Tensor
    cube_mass: torch.Tensor
    cube_active: torch.Tensor


@profiling.span("env.pre")
def _pre_substeps(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
                  gen: torch.Generator):
    """Everything before the physics substeps: action pipeline, disturbances,
    the attack spheres' update. Returns (_PreOut, the spheres' per-body
    wrenches (B, 13, 6) on the robot for the substeps, or None)."""
    B, dev = action.shape[0], action.device
    c = _consts(cfg, dev)
    # -- action scaling + filtering + multiplicative action noise (:700-705)
    ptarget = action * 1.0 + c.action_mean
    fp = cfg.filter_para
    ptarget = (1.0 - fp) * ptarget + fp * state.ptarget_last
    if cfg.action_noise:
        ptarget = ptarget * (1.0 + cfg.action_noise * _uniform(gen, (B, 12), dev))

    # -- disturbances
    if cfg.force_disturbance and not cfg.manual:
        base_wrench = _force_attack(cfg, gen, B, dev)
    else:
        base_wrench = torch.zeros((B, 6), device=dev)

    # -- manual-mode state kicks (state_disturbance, Environment.hpp:912-940)
    gc, gv = state.gc, state.gv
    if cfg.force_disturbance and cfg.manual:
        period_frames = max(int(cfg.period / cfg.control_dt * 10), 1)
        kick = ((state.frame_idx % period_frames) == 0)[:, None]
        kn_pos, kn_vel = _uniform(gen, (B, 7), dev), _uniform(gen, (B, 6), dev)
        ratio = 0.5
        quat = gc[:, 3:7] + 0.1 * kn_pos[:, 3:7] * ratio
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        gc_k = torch.cat([gc[:, :2], gc[:, 2:3] + 0.03 * kn_pos[:, 2:3] * ratio, quat,
                          gc[:, 7:]], dim=-1)
        gv_k = torch.cat([gv[:, :2], gv[:, 2:3] + 0.1 * kn_vel[:, 2:3] * ratio,
                          gv[:, 3:5] + 0.3 * kn_vel[:, 3:5] * ratio, gv[:, 5:]], dim=-1)
        gc = torch.where(kick, gc_k, gc)
        gv = torch.where(kick, gv_k, gv)

    # -- meteorite-attack curriculum (crucial learning, Environment.hpp:717-741)
    cube_pos, cube_vel = state.cube_pos, state.cube_vel
    cube_radius, cube_mass, cube_active = state.cube_radius, state.cube_mass, state.cube_active
    f_ext_extra = None
    if cfg.crucial:
        ring_frames = max(int(5 * cfg.period / cfg.control_dt), 1)
        respawn = (state.frame_idx % ring_frames) == 0
        pos_r, vel_r, rad_r, mass_r = _cube_ring_reset(cfg, gc, state.current_time)
        launch_vel = torch.cat([gv[:, None, :2].expand(-1, cube_vel.shape[1], 2),
                                torch.full_like(cube_vel[..., :1], -5.0)], dim=-1)
        do_launch = ~respawn & ~cube_active
        per_sphere = lambda m: m[:, None, None]  # noqa: E731
        cube_pos = torch.where(per_sphere(respawn), pos_r, cube_pos)
        cube_vel = torch.where(per_sphere(respawn), vel_r,
                               torch.where(per_sphere(do_launch), launch_vel, cube_vel))
        cube_radius = torch.where(respawn, rad_r, cube_radius)
        cube_mass = torch.where(respawn, mass_r, cube_mass)
        cube_active = ~respawn
        # integrate the spheres over the control step; their contact reaction
        # (body box + shank capsules) loads the robot during the substeps
        acc, reaction = _sphere_robot_forces(cfg, state.params, gc, cube_pos, cube_vel,
                                             cube_radius, cube_mass, state.terrain)
        dyn_mask = per_sphere(cube_active.to(gc.dtype))
        cube_vel = cube_vel + cfg.control_dt * acc * dyn_mask
        cube_pos = cube_pos + cfg.control_dt * cube_vel * dyn_mask
        f_ext_extra = reaction * dyn_mask
    return _PreOut(gc=gc, gv=gv, ptarget=ptarget, base_wrench=base_wrench, cube_pos=cube_pos,
                   cube_vel=cube_vel, cube_radius=cube_radius, cube_mass=cube_mass,
                   cube_active=cube_active), f_ext_extra


class _Diag(NamedTuple):
    toe_pos: torch.Tensor           # (B, 4, 3)
    toe_vel: torch.Tensor           # (B, 4, 3)
    toe_force_norm: torch.Tensor    # (B, 4)
    toe_normal_force: torch.Tensor  # (B, 4)


@profiling.span("env.step")
def step_batch(cfg: EnvConfig, states: EnvState, actions: torch.Tensor,
               gen: torch.Generator, tau_ff: torch.Tensor | None = None,
               pd_scale: torch.Tensor | None = None,
               ref_table: torch.Tensor | None = None) -> StepOut:
    """One control step of every env with auto-reset (blackpanther.py:793-854).

    The cfg.substeps (8) physics substeps, each after the PD torque from the
    fresh state, are one call of :func:`..ops.phys_cuda.control_step`: one
    launch of the CUDA kernel for tensors on the card, the plain loop on the
    CPU. Only the last substep's torque and toe rows are used after it. The
    work after the substeps (observation, reward, references, termination,
    the auto-reset) is, on the card, one CUDA-graph replay
    (:mod:`.post_graph`): the same kernels and random draws as the eager call.

    ``tau_ff``/``pd_scale`` ((B, 12) each, optional) are the Convert2Torque
    actuation of the JAX ``step``: a joint-torque feedforward and a scale on
    the PD feedback, held over the control step's substeps. On a terrain
    config the call carries the envs' terrain rows, with the heightmap or of
    the analytic fractal (JAX ``step_batch``'s ground_fn: vertical contact
    normal). A RefTraj ``ref_table`` changes only the references and the
    phase observation: still one launch a control step.

    The attack spheres (``cfg.crucial``) and hard contact
    (``cfg.hard_contact``) run on :func:`step` only, as in the JAX package
    (blackpanther.py:809-812): here they raise."""
    for flag, what in (("crucial", "the meteorite attacks"), ("hard_contact", "hard contact")):
        if getattr(cfg, flag):
            raise ValueError(f"step_batch runs the compliant no-attack physics; cfg.{flag} "
                             f"({what}) runs on the per-env step: use envs.blackpanther.step")
    pre, _ = _pre_substeps(cfg, states, actions, gen)
    with profiling.span("env.kernel"):
        P = lanes.params_to_lanes(states.params)
        rows = lambda x: None if x is None else x.T.contiguous()  # noqa: E731
        gcT, gvT, toe, toe_vel, fnorm, fnormal, tauT = phys_cuda.control_step(
            P, pd_torque.from_config(cfg), pre.gc.T.contiguous(), pre.gv.T.contiguous(),
            pre.ptarget.T.contiguous(), states.torque_norm_last.T.contiguous(),
            pre.base_wrench.T.contiguous(), cfg.substeps, cfg.contact_slip_vel,
            cfg.contact_impulse_mass / cfg.simulation_dt, cfg.simulation_dt,
            rows(tau_ff), rows(pd_scale), tr.rows(states.terrain) if cfg.terrain else None)
        diag = _Diag(toe_pos=toe.permute(2, 0, 1), toe_vel=toe_vel.permute(2, 0, 1),
                     toe_force_norm=fnorm.T, toe_normal_force=fnormal.T)
        gc, gv, tau = gcT.T.contiguous(), gvT.T.contiguous(), tauT.T.contiguous()
    return _post_graphs(cfg, states, gen, gc, gv, tau, diag, pre, ref_table)


@profiling.span("env.step")
def step(cfg: EnvConfig, states: EnvState, actions: torch.Tensor, gen: torch.Generator,
         tau_ff: torch.Tensor | None = None,
         pd_scale: torch.Tensor | None = None,
         ref_table: torch.Tensor | None = None) -> StepOut:
    """One control step of every env with auto-reset on the per-env physics
    (blackpanther.py:654-703; the batched counterpart of JAX's
    ``vmap(step)``).

    The same action pipeline, disturbances, observation, reward and reset as
    :func:`step_batch`, drawing from ``gen`` in the same order; the cfg.substeps
    (8) substeps each recompute the PD torque from the fresh state, then run
    the dense dynamics of :mod:`..phys.dynamics`: ``forward_dynamics`` +
    ``integrate`` with the terrain's own contact normal, or under
    ``cfg.hard_contact`` the impulse solve of ``substep_hard``, its impulses
    zeroed at the control step's start and warm-started across its substeps.
    Under ``cfg.crucial`` the attack spheres' wrenches load the robot in
    every substep. ``tau_ff``/``pd_scale`` ((B, 12) each, optional) are the
    Convert2Torque inputs, held over the substeps; ``ref_table`` as in
    :func:`step_batch`."""
    pre, f_ext_extra = _pre_substeps(cfg, states, actions, gen)
    pd = pd_torque.from_config(cfg)
    gc, gv, dt = pre.gc, pre.gv, cfg.simulation_dt
    lam = None      # the impulses start from zero at each control step
    for _ in range(cfg.substeps):
        tau = pd_torque.pd_torque(pd, pre.ptarget, states.torque_norm_last, gc[:, 7:], gv[:, 6:],
                                  tau_ff, pd_scale)
        if cfg.hard_contact:
            gc, gv, diag, lam = dyn.substep_hard(states.params, gc, gv, tau, pre.base_wrench,
                                                 states.terrain, dt, f_ext_extra,
                                                 cfg.hard_contact_iters, lam)
        else:
            qdd, diag = dyn.forward_dynamics(
                states.params, gc, gv, tau, pre.base_wrench, states.terrain,
                cfg.contact_slip_vel, f_ext_extra=f_ext_extra,
                impulse_scale=cfg.contact_impulse_mass / dt)
            gc, gv = dyn.integrate(gc, gv, qdd, dt)
    return _post_substeps(cfg, states, gen, gc, gv, tau, diag, pre, ref_table)


@profiling.span("env.post")
def _post_substeps(cfg: EnvConfig, state: EnvState, gen: torch.Generator, gc, gv,
                   torque_applied, last_diag, pre: _PreOut, ref_table=None) -> StepOut:
    """Everything after the physics substeps: observation, reward, reference
    update, termination and the branchless auto-reset. Shared by
    :func:`step` and :func:`step_batch`; ``last_diag`` is the last substep's
    :class:`_Diag` or ``phys.dynamics.StepDiagnostics``."""
    # -- observation at the new state (time = state.current_time)
    t = state.current_time
    phase_now = None
    if _uses_table(cfg, ref_table) and not cfg.manual:
        phase_now = _table_rows(ref_table, state.frame_idx)[:, 25:27]
    obs, v_body, w_body, R = _raw_observation(cfg, gen, gc, gv, state.command_filtered, t,
                                              phase_now)

    # -- contact information (impulse-scaled force norm)
    contact_force_norm = last_diag.toe_force_norm * (cfg.simulation_dt / cfg.control_dt)
    contact_vel_norm = torch.linalg.vector_norm(last_diag.toe_vel, dim=-1)
    if cfg.time_based_contact:
        # phase-scheduled contact flags (contact_obs_update, Environment.hpp:1169-1193)
        offsets = _consts(cfg, gc.device).phase_offsets
        ph = torch.remainder(t[:, None] + offsets * cfg.period, cfg.period) / cfg.period
        contact_flag = (ph < cfg.lam).to(gc.dtype)
    else:
        contact_flag = (last_diag.toe_normal_force > 0.0).to(gc.dtype)

    # -- reward against the references generated last step
    rew = deep_mimic_reward(
        cfg, t, gc, gv, obs, v_body, w_body, R, last_diag.toe_pos, state.joint_ref,
        state.joint_dot_ref, state.ee_ref, state.command_filtered, torque_applied,
        state.torque_norm_last, contact_vel_norm, contact_force_norm)

    # -- next references (command_obs_update(false) after reward, :784)
    upd = _update_references(cfg, gen, state.command, state.command_filtered,
                             state.joint_ref, state.joint_dot_ref, t, state.frame_idx,
                             is_reset=False, ref_table=ref_table)
    obs = torch.cat([upd.command_filtered, obs[:, 3:]], dim=-1)

    # -- obs low-pass (observe(), Environment.hpp:1251-1256)
    if cfg.obs_filter:
        alpha = cfg.obs_filter_alpha
        obs = torch.cat([obs[:, :5], obs[:, 5:] * alpha + state.obs_last[:, 5:] * (1.0 - alpha)],
                        dim=-1)

    # -- termination (isTerminalState, :1553-1578) with the noisy posture obs
    done = (gc[:, 2] < 0.15) | (gc[:, 2] > 0.65) | (obs[:, 31] < 0.5)
    reward = rew.total + torch.where(done, cfg.terminal_reward, 0.0)

    new_state = state.replace(
        gc=gc, gv=gv, ptarget_last=pre.ptarget, torque_norm_last=rew.torque_norm,
        torque_applied=torque_applied, base_wrench=pre.base_wrench,
        command=upd.command, command_filtered=upd.command_filtered,
        joint_ref=upd.joint_ref, joint_ref_last=upd.joint_ref,
        joint_dot_ref=upd.joint_dot_ref, ee_ref=upd.ee_ref,
        current_time=t + cfg.control_dt, frame_idx=state.frame_idx + 1,
        contact_filtered=contact_flag, contact_force_norm=contact_force_norm,
        contact_vel_norm=contact_vel_norm, obs_double=obs, obs_last=obs,
        done=done, ep_return=state.ep_return + reward, ep_len=state.ep_len + 1,
        reward_terms=rew.terms, cube_pos=pre.cube_pos, cube_vel=pre.cube_vel,
        cube_radius=pre.cube_radius, cube_mass=pre.cube_mass, cube_active=pre.cube_active)

    # -- auto-reset with terminal reward (perAgentStep, VectorizedEnvironment.hpp:352-372)
    out_state = _where(done, reset(cfg, new_state, gen, ref_table), new_state)
    info = {"reward_terms": rew.terms, "ep_return": new_state.ep_return,
            "ep_len": new_state.ep_len, "base_height": gc[:, 2], "contact": contact_flag}
    return StepOut(state=out_state, obs=normalize_obs(cfg, out_state.obs_double),
                   reward=reward, done=done, info=info)


# step_batch's call of _post_substeps: a CUDA-graph replay on the card (envs/post_graph)
_post_graphs = post_graph.PostGraphs(_post_substeps)


def _where(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-env select of two states (params and terrain are shared by both)."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)
    kw = {f.name: sel(getattr(a, f.name), getattr(b, f.name))
          for f in dataclasses.fields(EnvState) if f.name not in ("params", "terrain")}
    return b.replace(**kw)


# --- introspection parity (Environment.hpp:1317-1402), (B, ...) each -----------------

def origin_state(state: EnvState) -> torch.Tensor:
    """gc(19) + gv(18) + contact(4) = 41 floats (OriginState)."""
    return torch.cat([state.gc, state.gv, state.contact_filtered], dim=-1)


def reference_state(state: EnvState) -> torch.Tensor:
    return torch.cat([state.joint_ref, state.joint_dot_ref], dim=-1)


def joint_effort(state: EnvState) -> torch.Tensor:
    return state.torque_applied


def generalized_force(state: EnvState) -> torch.Tensor:
    """Applied generalized force [base wrench(6); joint torques(12)]
    (GetGeneralizedForce, Environment.hpp:1363-1370)."""
    return torch.cat([state.base_wrench, state.torque_applied], dim=-1)


def inverse_mass_matrix(state: EnvState) -> torch.Tensor:
    return dyn.inverse_mass_matrix(state.params, state.gc)


def nonlinear(state: EnvState) -> torch.Tensor:
    return dyn.nonlinearities(state.params, state.gc, state.gv)


def sphere_info(state: EnvState) -> torch.Tensor:
    """First attack sphere [x, y, z, radius] (GetSphereInfo, Environment.hpp:1423-1436)."""
    return torch.cat([state.cube_pos[:, 0], state.cube_radius[:, None]], dim=-1)
