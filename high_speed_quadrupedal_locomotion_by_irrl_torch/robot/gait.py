"""Bezier gait reference generation (the ManualTraj mode), batched.

Port of ``robot/gait.gait_reference`` (gait_generator_manual,
Environment.hpp:1756-1890): per-leg phase offsets, a cubic-Bezier stance
sweep at -stand_height, a swing arc with a Gaussian apex, and analytic IK
into joint references. The defaults are the learned policy's imitation
profile; the SRB runtime adds a Raibert foothold shift (``xy_shift``) and the
touchdown-matched profile (``touchdown_match``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import EE_OFFSET, L_HIP
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot.kinematics import legs_ik

# front legs sweep (+), hind legs (-) for the yaw component (Environment.hpp:1848)
_ANTI_FLAG = np.array([1.0, 1.0, -1.0, -1.0])


class GaitRef(NamedTuple):
    joint_ref: torch.Tensor  # (B, 12)
    toe: torch.Tensor        # (B, 4, 3) toe targets in hip frames
    ee_ref: torch.Tensor     # (B, 12) end-effector reference relative to body center


def _bezier_blend(phase: torch.Tensor) -> torch.Tensor:
    """cubicBezier's smooth blend: phi^3 + 3 phi^2 (1-phi)."""
    return phase ** 3 + 3.0 * phase ** 2 * (1.0 - phase)


def _gauss(x: torch.Tensor, width: float, height: torch.Tensor) -> torch.Tensor:
    s = width / 6.0
    return height * torch.exp(-((x - width / 2) ** 2) / (2 * s * s))


def swing_up_height(cfg: EnvConfig, command: torch.Tensor) -> torch.Tensor:
    """HeightVariable scaling of the swing apex (Environment.hpp:1779-1792);
    command (B, 3) -> (B,)."""
    if not cfg.height_variable:
        return torch.full(command.shape[:-1], cfg.up_height, dtype=command.dtype,
                          device=command.device)
    ratio = torch.abs(command[..., 0]) / cfg.vx_max
    if cfg.vy_max > 0:
        ratio = torch.maximum(ratio, torch.abs(command[..., 1]) / cfg.vy_max)
    if cfg.omega_max > 0:
        ratio = torch.maximum(ratio, torch.abs(command[..., 2] / cfg.omega_max))
    return torch.where(ratio > 0.1, torch.full_like(ratio, cfg.up_height),
                       ratio * cfg.up_height)


def toe_targets(cfg: EnvConfig, command: torch.Tensor, t: torch.Tensor,
                touchdown_match: bool = False) -> torch.Tensor:
    """(B, 4, 3) toe positions in the hip frames at gait time t (B,).

    touchdown_match=True is the MPC-grade profile of the JAX package
    (``gait.toe_targets``): a linear stance sweep, and a late-swing retraction
    whose rate at touchdown equals the stance sweep's, so the foot lands
    moving with the ground. The default is the reference's generator."""
    dev = command.device
    gait_step = command[..., 0] * cfg.lam * cfg.period
    if cfg.wildcat:
        gait_step = -gait_step
    side_step = command[..., 1] * cfg.lam * cfg.period
    rot_step = command[..., 2] * cfg.period * 0.4
    up = swing_up_height(cfg, command)

    offsets = dev_mod.tensor(cfg.phase_offsets, dev)
    phase = torch.remainder(t[..., None] + offsets * cfg.period, cfg.period) / cfg.period
    anti = dev_mod.tensor(_ANTI_FLAG, dev)
    half = torch.stack([
        (gait_step / 2.0)[..., None].expand(phase.shape),
        side_step[..., None] / 2.0 + anti * rot_step[..., None] / 2.0,
        torch.full_like(phase, -cfg.stand_height),
    ], dim=-1)                                          # (B,4,3) "forward" endpoint
    p_fwd = half
    p_back = torch.stack([-half[..., 0], -half[..., 1], half[..., 2]], dim=-1)

    in_stance = phase < cfg.lam
    r_st = phase / cfg.lam
    r_sw = (phase - cfg.lam) / (1.0 - cfg.lam)
    if touchdown_match:
        b_st = torch.clamp(r_st, 0.0, 1.0)[..., None]     # linear, constant rate
    else:
        b_st = _bezier_blend(r_st)[..., None]
    toe_st = p_fwd + b_st * (p_back - p_fwd)
    b_sw = _bezier_blend(r_sw)[..., None]
    toe_sw_xy = p_back[..., :2] + b_sw * (p_fwd[..., :2] - p_back[..., :2])
    if touchdown_match:
        # parabolic retraction over the last 20% of swing (gait.py:101-108)
        u = torch.clamp((r_sw - 0.8) / 0.2, 0.0, 1.0)[..., None]
        rate = (p_fwd[..., :2] - p_back[..., :2]) * (1.0 - cfg.lam) / cfg.lam
        toe_sw_xy = toe_sw_xy - 0.5 * 0.2 * rate * u ** 2
    toe_sw_z = p_back[..., 2] + _gauss(r_sw, 1.0, up[..., None])
    toe_sw = torch.cat([toe_sw_xy, toe_sw_z[..., None]], dim=-1)
    return torch.where(in_stance[..., None], toe_st, toe_sw)


def hip_y_offsets(cfg: EnvConfig) -> np.ndarray:
    """temp_offset (Environment.hpp:1794-1798)."""
    return np.array([-L_HIP + cfg.lean_front, L_HIP - cfg.lean_front,
                     -L_HIP + cfg.lean_hind, L_HIP - cfg.lean_hind])


def gait_reference(cfg: EnvConfig, command: torch.Tensor, t: torch.Tensor,
                   xy_shift: torch.Tensor | None = None,
                   touchdown_match: bool = False) -> GaitRef:
    """Joint + end-effector reference at gait time t (B,) for the filtered
    command (B, 3). xy_shift (B, 2): a horizontal Raibert foothold correction
    added to every toe target of an env (the SRB runtime's form)."""
    dev = command.device
    toe = toe_targets(cfg, command, t, touchdown_match)
    if xy_shift is not None:
        toe = torch.cat([toe[..., :2] + xy_shift[..., None, :], toe[..., 2:]], dim=-1)
    ik_in = toe.clone()
    ik_in[..., 1] = ik_in[..., 1] + dev_mod.tensor(hip_y_offsets(cfg), dev)
    joint_ref = legs_ik(ik_in)
    ee_ref = (toe + dev_mod.tensor(EE_OFFSET, dev)).reshape(toe.shape[:-2] + (12,))
    return GaitRef(joint_ref=joint_ref, toe=toe, ee_ref=ee_ref)
