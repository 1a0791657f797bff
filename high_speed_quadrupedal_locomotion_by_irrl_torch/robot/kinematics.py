"""Closed-form leg kinematics (branchless, batched over leading dims).

Port of ``robot/kinematics``: the reference's analytic 3-DoF IK solver
(Environment.hpp:1687-1751) with its error branches replaced by clamps, the
forward map ``leg_fk``/``legs_fk``, and the leg Jacobian in closed form (the
JAX package takes it by ``jax.jacfwd`` of ``leg_fk``).
q = [abad (about +x), hip (about -y), knee (about -y)].
"""

from __future__ import annotations

import functools
import math

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import (
    IS_RIGHT, L_CALF, L_HIP, L_THIGH,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling


@functools.cache
def _is_right(device: torch.device) -> torch.Tensor:
    """The (4,) right-leg flags on ``device``, made once a device (the copy
    from the host counts as one ``host_copies``) and kept for the process's
    life, since the env step's CUDA graphs read them by address."""
    profiling.count("host_copies")
    return torch.as_tensor(IS_RIGHT, device=device)


def leg_ik(p: torch.Tensor, is_right: torch.Tensor,
           l_hip: float = L_HIP, l_thigh: float = L_THIGH,
           l_calf: float = L_CALF) -> torch.Tensor:
    """Toe target (..., 3) in the hip frame -> leg joint angles (..., 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    max_len = math.sqrt(l_hip ** 2 + (l_thigh + l_calf) ** 2)
    ll = torch.sqrt(x * x + y * y + z * z)
    scale = torch.where(ll > max_len, (max_len - 1e-5) / torch.clamp_min(ll, 1e-9),
                        torch.ones_like(ll))
    x, y, z = x * scale, y * scale, z * scale

    yz2 = z * z + y * y
    root = torch.sqrt(torch.clamp_min(y * y * (yz2 - l_hip * l_hip), 0.0))
    t_right = (-z * l_hip - root) / torch.clamp_min(yz2, 1e-9)
    t_left = (z * l_hip + root) / torch.clamp_min(yz2, 1e-9)
    theta0 = torch.arcsin(torch.clamp(torch.where(is_right, t_right, t_left), -1.0, 1.0))

    lr = torch.sqrt(torch.clamp_min(x * x + y * y + z * z - l_hip * l_hip, 1e-12))
    lr = torch.clamp_max(lr, l_thigh + l_calf - 1e-4)
    c_knee = (l_thigh ** 2 + l_calf ** 2 - lr * lr) / (2 * l_thigh * l_calf) + 1e-5
    theta2 = -(math.pi - torch.arccos(torch.clamp(c_knee, -1.0, 1.0)))
    s_pitch = torch.clamp(x / lr, -1.0, 1.0)
    c_hip = (lr * lr + l_thigh ** 2 - l_calf ** 2) / (2 * lr * l_thigh) - 1e-5
    theta1 = torch.arccos(torch.clamp(c_hip, -1.0, 1.0)) - torch.arcsin(s_pitch)
    return torch.stack([theta0, -theta1, -theta2], dim=-1)


def legs_ik(targets: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) hip-frame toe targets (FR,FL,HR,HL) -> (..., 12) angles."""
    is_right = _is_right(targets.device)
    return leg_ik(targets, is_right).reshape(targets.shape[:-2] + (12,))


def leg_fk(q: torch.Tensor, is_right: torch.Tensor,
           l_hip: float = L_HIP, l_thigh: float = L_THIGH,
           l_calf: float = L_CALF) -> torch.Tensor:
    """Joint angles (..., 3) -> toe position (..., 3) in the hip (abad-joint) frame."""
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    sy = torch.where(is_right, -1.0, 1.0)
    # chain: Rx(q0) [ (0, sy*lh, 0) + R-y(q1) ( (0,0,-l1) + R-y(q2)(0,0,-l2) ) ]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s12, c12 = torch.sin(q1 + q2), torch.cos(q1 + q2)
    px = l_thigh * s1 + l_calf * s12
    pz_leg = -(l_thigh * c1 + l_calf * c12)
    c0, s0 = torch.cos(q0), torch.sin(q0)
    py = sy * l_hip * c0 - pz_leg * s0
    pz = sy * l_hip * s0 + pz_leg * c0
    return torch.stack([px, py, pz], dim=-1)


def leg_jacobian(q: torch.Tensor, is_right: torch.Tensor,
                 l_hip: float = L_HIP, l_thigh: float = L_THIGH,
                 l_calf: float = L_CALF) -> torch.Tensor:
    """d leg_fk / dq: (..., 3) -> (..., 3, 3), row i the toe coordinate,
    column j the joint."""
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    sy = torch.where(is_right, -1.0, 1.0)
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s12, c12 = torch.sin(q1 + q2), torch.cos(q1 + q2)
    c0, s0 = torch.cos(q0), torch.sin(q0)
    pz_leg = -(l_thigh * c1 + l_calf * c12)
    dx1, dx2 = l_thigh * c1 + l_calf * c12, l_calf * c12     # d px / d q1, q2
    dz1, dz2 = l_thigh * s1 + l_calf * s12, l_calf * s12     # d pz_leg / d q1, q2
    zero = torch.zeros_like(q0)
    rows = [[zero, dx1, dx2],
            [-sy * l_hip * s0 - pz_leg * c0, -dz1 * s0, -dz2 * s0],
            [sy * l_hip * c0 - pz_leg * s0, dz1 * c0, dz2 * c0]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def legs_fk(q: torch.Tensor) -> torch.Tensor:
    """(..., 12) joint angles -> (..., 4, 3) hip-frame toe positions."""
    is_right = _is_right(q.device)
    return leg_fk(q.reshape(q.shape[:-1] + (4, 3)), is_right)


def legs_jacobian(q: torch.Tensor) -> torch.Tensor:
    """(..., 12) joint angles -> (..., 4, 3, 3) leg Jacobians (FR, FL, HR, HL)."""
    is_right = _is_right(q.device)
    return leg_jacobian(q.reshape(q.shape[:-1] + (4, 3)), is_right)
