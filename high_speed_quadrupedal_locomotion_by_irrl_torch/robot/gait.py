"""Bezier gait reference generation (the ManualTraj mode), batched.

Port of ``robot/gait.gait_reference`` (gait_generator_manual,
Environment.hpp:1756-1890): per-leg phase offsets, a cubic-Bezier stance
sweep at -stand_height, a swing arc with a Gaussian apex, and analytic IK
into joint references. Only the learned policy's imitation profile is ported
(no Raibert shift, no touchdown matching: those serve the MPC runtimes).
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


def toe_targets(cfg: EnvConfig, command: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 4, 3) toe positions in the hip frames at gait time t (B,)."""
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
    b_st = _bezier_blend(r_st)[..., None]
    toe_st = p_fwd + b_st * (p_back - p_fwd)
    b_sw = _bezier_blend(r_sw)[..., None]
    toe_sw_xy = p_back[..., :2] + b_sw * (p_fwd[..., :2] - p_back[..., :2])
    toe_sw_z = p_back[..., 2] + _gauss(r_sw, 1.0, up[..., None])
    toe_sw = torch.cat([toe_sw_xy, toe_sw_z[..., None]], dim=-1)
    return torch.where(in_stance[..., None], toe_st, toe_sw)


def hip_y_offsets(cfg: EnvConfig) -> np.ndarray:
    """temp_offset (Environment.hpp:1794-1798)."""
    return np.array([-L_HIP + cfg.lean_front, L_HIP - cfg.lean_front,
                     -L_HIP + cfg.lean_hind, L_HIP - cfg.lean_hind])


def gait_reference(cfg: EnvConfig, command: torch.Tensor, t: torch.Tensor) -> GaitRef:
    """Joint + end-effector reference at gait time t (B,) for the filtered
    command (B, 3)."""
    dev = command.device
    toe = toe_targets(cfg, command, t)
    ik_in = toe.clone()
    ik_in[..., 1] = ik_in[..., 1] + dev_mod.tensor(hip_y_offsets(cfg), dev)
    joint_ref = legs_ik(ik_in)
    ee_ref = (toe + dev_mod.tensor(EE_OFFSET, dev)).reshape(toe.shape[:-2] + (12,))
    return GaitRef(joint_ref=joint_ref, toe=toe, ee_ref=ee_ref)
