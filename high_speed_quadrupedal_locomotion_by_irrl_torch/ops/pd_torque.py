"""Joint torque of one physics substep: PD law, torque smoothing, electrical
motor model and the speed-dependent envelope clamp, elementwise over the 12
joints (``Environment.hpp:161-208, 1273-1312``; the JAX package's
``envs/blackpanther._pd_torque``, ``real_torque`` and ``torque_clamp``).

These are the plain PyTorch functions. The fused control step of
``csrc/phys_substep.cu`` computes the same torque in the kernel from
:class:`PDConsts`, whose per-joint values depend only on the link of a leg
(abduct, thigh, shank) and so travel as 3-tuples of Python floats.
:mod:`..envs.blackpanther` re-exports the functions under their old names.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl

# electrical motor model (RealTorque, Environment.hpp:161-208)
_MOTOR_KT, _MOTOR_R, _MOTOR_TAU_MAX, _MOTOR_BATTERY_V = 0.05, 0.173, 3.0, 24.0
_MOTOR_DAMPING, _MOTOR_FRICTION = 0.01, 0.2
# the same, in the order the control-step kernel takes them after PDConsts
MOTOR_MODEL = (_MOTOR_KT, _MOTOR_R, _MOTOR_TAU_MAX, _MOTOR_BATTERY_V, _MOTOR_DAMPING,
               _MOTOR_FRICTION)

Triple = tuple[float, float, float]


class PDConsts(NamedTuple):
    """PD gains and motor envelope; 3-tuples are by link of a leg."""
    kp: Triple
    kd: Triple
    knee_ratio: Triple
    gear: Triple
    max_torque: float
    critical_speed: float
    max_speed: float
    motor_dynamics: bool

    @property
    def slope(self) -> float:
        """Torque lost per rad/s of motor speed above the critical speed."""
        return self.max_torque / (self.max_speed - self.critical_speed)


def _gear_by_link() -> Triple:
    """The 12 gear ratios as a by-link triple; they must repeat leg by leg."""
    gear = tuple(float(g) for g in mdl.GEAR_RATIO)
    if len(gear) != 12 or gear != gear[:3] * 4:
        raise ValueError(f"gear ratios differ between legs: {gear}")
    return gear[:3]


@functools.lru_cache(maxsize=16)
def from_config(cfg) -> PDConsts:
    gain = (cfg.abad_ratio, 1.0, 1.0)
    return PDConsts(
        kp=tuple(cfg.stiffness * g for g in gain), kd=tuple(cfg.damping * g for g in gain),
        knee_ratio=(1.0, 1.0, mdl.KNEE_RATIO), gear=_gear_by_link(),
        max_torque=cfg.motor_max_torque, critical_speed=cfg.motor_critical_speed,
        max_speed=cfg.motor_max_speed, motor_dynamics=bool(cfg.motor_dynamics))


@functools.lru_cache(maxsize=64)
def _per_joint(triple: Triple, device: torch.device) -> torch.Tensor:
    """A by-link triple as a (12,) tensor on ``device``."""
    return dev_mod.tensor(list(triple) * 4, device)


def torque_clamp(pd: PDConsts, torque: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Speed-dependent motor-envelope clamp on the (..., 12) joint torques."""
    kr = _per_joint(pd.knee_ratio, torque.device)
    tm, cs, ms = pd.max_torque, pd.critical_speed, pd.max_speed
    w = qd * kr
    up = torch.where(w > cs, tm - (w - cs) * pd.slope, torch.full_like(w, tm)) * kr
    low = torch.where(w < -cs, (-ms - w) / (-ms + cs) * -tm, torch.full_like(w, -tm)) * kr
    return torch.minimum(torch.maximum(torque, low), up)


def real_torque(torque: torch.Tensor, qd: torch.Tensor, friction: bool = True) -> torch.Tensor:
    """Simplified electrical motor model: current/back-EMF/battery-voltage
    saturation + Coulomb friction (the MotorDynamics flag), with the symmetric
    final clamp the JAX package implements."""
    gear = _per_joint(_gear_by_link(), torque.device)
    tau_motor = torque / gear
    i_des = tau_motor / (_MOTOR_KT * 1.5)
    bemf = qd * gear * _MOTOR_KT * 2.0
    v_des = i_des * _MOTOR_R + bemf
    v_act = torch.clamp(v_des, -_MOTOR_BATTERY_V, _MOTOR_BATTERY_V)
    tau_act = 1.5 * _MOTOR_KT * (v_act - bemf) / _MOTOR_R
    out = gear * torch.clamp(tau_act, -_MOTOR_TAU_MAX, _MOTOR_TAU_MAX)
    if friction:
        out = out - _MOTOR_DAMPING * qd - _MOTOR_FRICTION * torch.sign(qd)
    return out


def pd_torque(pd: PDConsts, ptarget: torch.Tensor, torque_norm_last: torch.Tensor,
              q: torch.Tensor, qd: torch.Tensor, tau_ff: torch.Tensor | None = None,
              pd_scale: torch.Tensor | None = None) -> torch.Tensor:
    """PD -> ``x pd_scale`` -> smoothing quirk -> ``+ tau_ff`` -> motor model
    -> envelope clamp, elementwise over (..., 12). The smoothing mixes in 1% of
    the *normalized* torque of the previous control step, as the reference
    does. ``tau_ff``/``pd_scale`` are the Convert2Torque inputs (a joint-torque
    feedforward and a scale on the PD feedback; JAX ``_pd_torque``); the
    envelope clamp applies to the sum."""
    tau = _per_joint(pd.kp, q.device) * (ptarget - q) - _per_joint(pd.kd, q.device) * qd
    if pd_scale is not None:
        tau = tau * pd_scale
    tau = 0.99 * tau + 0.01 * torque_norm_last
    if tau_ff is not None:
        tau = tau + tau_ff
    if pd.motor_dynamics:
        tau = real_torque(tau, qd)
    return torque_clamp(pd, tau, qd)
