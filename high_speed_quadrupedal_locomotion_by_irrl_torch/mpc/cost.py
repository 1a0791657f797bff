"""Differentiable trajectory costs derived from the IRRL reward terms,
batched over leading dims.

Port of ``mpc/cost.py``: the DeepMimic tracking rewards (Environment.hpp:
1444-1548) as smooth quadratics — joint and joint-rate mimic, body height,
attitude, body-frame linear and angular velocity, normalized PD torque and
control effort. :func:`imitation_weights` and :func:`relaxation_weights` are
the two phases of the IRRL workflow as cost presets.

Every argument may carry leading dims; they broadcast against each other
(e.g. states (A, B, T, 37) against references (B, T, 12) and commands
(B, 1, 3)), and the cost has the broadcast leading shape.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix


@dataclasses.dataclass(frozen=True)
class CostWeights:
    joint: float = 10.0
    joint_dot: float = 0.02
    height: float = 40.0
    attitude: float = 20.0
    velocity: float = 2.0
    angular_velocity: float = 1.0
    torque: float = 0.02
    control: float = 0.1


def imitation_weights() -> CostWeights:
    """Imitation phase: mimic-dominated (JointRewardCoeff high)."""
    return CostWeights()


def relaxation_weights() -> CostWeights:
    """Relaxation phase: velocity/torque-dominated (readme.md:71-75 workflow)."""
    return CostWeights(joint=1.0, joint_dot=0.005, velocity=10.0,
                       angular_velocity=2.0, torque=0.2, control=0.2)


@functools.lru_cache(maxsize=16)
def _consts(abad: float, device: torch.device):
    """(stand joint pose (12,), torque limits (12,)) on ``device``."""
    return (dev_mod.tensor(mdl.stand_gc(abad)[7:], device),
            dev_mod.tensor(mdl.TORQUE_LIMIT_J, device))


def _body_frame(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v for (..., 3, 3) and (..., 3)."""
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def stage_cost(cfg: EnvConfig, w: CostWeights, x: torch.Tensor, u: torch.Tensor,
               joint_ref: torch.Tensor, joint_dot_ref: torch.Tensor,
               command: torch.Tensor) -> torch.Tensor:
    """x = [gc(19); gv(18)], u = normalized action (PD target offset)."""
    stand_q, torque_limit = _consts(cfg.abad, x.device)
    gc, gv = x[..., :19], x[..., 19:]
    q, qd = gc[..., 7:], gv[..., 6:]
    R = quat_to_matrix(gc[..., 3:7])
    v_body = _body_frame(R, gv[..., :3])
    w_body = _body_frame(R, gv[..., 3:6])
    zero = torch.zeros_like(command[..., 0])
    v_ref = torch.stack([command[..., 0], command[..., 1], zero], dim=-1)
    w_ref = torch.stack([zero, zero, command[..., 2]], dim=-1)

    ptarget = u + stand_q
    tau = cfg.stiffness * (ptarget - q) - cfg.damping * qd
    tau_n = tau / torque_limit

    return (w.joint * torch.sum((q - joint_ref) ** 2, dim=-1)
            + w.joint_dot * torch.sum((qd - joint_dot_ref) ** 2, dim=-1)
            + w.height * (gc[..., 2] - cfg.stand_height) ** 2
            + w.attitude * torch.sum(R[..., 2, :2] ** 2, dim=-1)
            + w.velocity * torch.sum((v_body - v_ref) ** 2, dim=-1)
            + w.angular_velocity * torch.sum((w_body - w_ref) ** 2, dim=-1)
            + w.torque * torch.sum(tau_n ** 2, dim=-1)
            + w.control * torch.sum(u ** 2, dim=-1))


def terminal_cost(cfg: EnvConfig, w: CostWeights, x: torch.Tensor,
                  joint_ref: torch.Tensor, command: torch.Tensor) -> torch.Tensor:
    gc, gv = x[..., :19], x[..., 19:]
    R = quat_to_matrix(gc[..., 3:7])
    v_body = _body_frame(R, gv[..., :3])
    v_ref = torch.stack([command[..., 0], command[..., 1], torch.zeros_like(command[..., 0])],
                        dim=-1)
    return (w.joint * torch.sum((gc[..., 7:] - joint_ref) ** 2, dim=-1)
            + w.height * (gc[..., 2] - cfg.stand_height) ** 2
            + w.attitude * torch.sum(R[..., 2, :2] ** 2, dim=-1)
            + w.velocity * torch.sum((v_body - v_ref) ** 2, dim=-1))
