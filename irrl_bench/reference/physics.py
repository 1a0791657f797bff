"""Plain PyTorch rigid-body physics of the 12-DoF BlackPanther: one control step.

The benchmark's yardstick for the port's fused physics kernel
(``phys_control_step_kernel``). It is written from the robot's equations,
not from the kernel: composite-rigid-body mass matrix and recursive
Newton-Euler bias forces in world-origin spatial coordinates, a penalty
contact at the four toe spheres and the eight base-box corners on flat
ground, a Cholesky solve of M qdd = tau - h, semi-implicit Euler. Each of the
control step's substeps recomputes the PD torque (stiffness, damping, the 1 %
smoothing with the previous step's normalized torque, the motor envelope
clamp) from the fresh state, as the simulator the port follows does.

Everything is batched over a leading env axis and stays in float32; the
matrix products go through :mod:`.numerics`, which the control runs in TF32.
Nothing here imports the port: the model constants are copied from
black_panther.urdf as the port's ``phys/model.py`` states them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from irrl_bench.reference.numerics import ein, mm

GRAVITY = (0.0, 0.0, -9.81)
NUM_BODIES = 13
PARENT = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11)
# joint axes in the parent frame: abduct +x, thigh and knee -y, leg by leg
JOINT_AXIS = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, -1.0, 0.0)) * 4
SHANKS = (3, 6, 9, 12)
TOE_OFFSET_Z = -0.19
TOE_RADIUS = 0.0275
BOX_HALF = (0.15, 0.10, 0.05)
ROTOR_INERTIA = (0.003708, 0.003708, 0.008966) * 4
JOINT_DAMPING = 0.01
GEAR = (6.0, 6.0, 9.33)
KNEE_RATIO = 1.55
# electrical motor model (the MotorDynamics flag)
MOTOR_KT, MOTOR_R, MOTOR_TAU_MAX, MOTOR_BATTERY_V = 0.05, 0.173, 3.0, 24.0
MOTOR_DAMPING, MOTOR_FRICTION = 0.01, 0.2


class Robot(NamedTuple):
    """Per-env parameters, env axis first."""
    mass: torch.Tensor          # (B, 13)
    com: torch.Tensor           # (B, 13, 3) body frame
    inertia: torch.Tensor       # (B, 13, 3, 3) about the com, body frame
    joint_origin: torch.Tensor  # (B, 12, 3) parent frame
    friction: torch.Tensor      # (B,)
    kn: torch.Tensor            # (B,) contact stiffness
    dn: torch.Tensor            # (B,) contact damping


class Settings(NamedTuple):
    """What a control step needs of the environment's configuration."""
    n_substeps: int
    dt: float
    slip_vel: float
    impulse_scale: float
    kp: torch.Tensor            # (12,)
    kd: torch.Tensor            # (12,)
    knee: torch.Tensor          # (12,) speed ratio of the envelope
    gear: torch.Tensor          # (12,)
    max_torque: float
    critical_speed: float
    max_speed: float
    motor_dynamics: bool


def settings(env: dict, contact: dict, device) -> Settings:
    """Settings from a configuration's environment mapping (the reference's
    YAML keys) and its contact model."""
    sim_dt, ctrl_dt = float(env["simulation_dt"]), float(env["control_dt"])
    ratio, kp, kd = float(env["AbadRatio"]), float(env["Stiffness"]), float(env["Damping"])
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return Settings(
        n_substeps=int(round(ctrl_dt / sim_dt)), dt=sim_dt,
        slip_vel=float(contact["contact_slip_vel"]),
        impulse_scale=float(contact["contact_impulse_mass"]) / sim_dt,
        kp=t([kp * ratio, kp, kp] * 4), kd=t([kd * ratio, kd, kd] * 4),
        knee=t([1.0, 1.0, KNEE_RATIO] * 4), gear=t(list(GEAR) * 4),
        max_torque=float(env["MotorMaxTorque"]),
        critical_speed=float(env["MotorCriticalSpeed"]),
        max_speed=float(env["MotorMaxSpeed"]),
        motor_dynamics=bool(env["MotorDynamics"]))


# --- joint torque ------------------------------------------------------------

def _envelope(s: Settings, tau: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Speed-dependent motor envelope: full torque up to the critical speed,
    falling linearly to 0 at the maximum speed, in each direction."""
    tm, cs, ms = s.max_torque, s.critical_speed, s.max_speed
    w = qd * s.knee
    slope = tm / (ms - cs)
    up = torch.where(w > cs, tm - (w - cs) * slope, torch.full_like(w, tm)) * s.knee
    low = torch.where(w < -cs, (-ms - w) / (-ms + cs) * -tm, torch.full_like(w, -tm)) * s.knee
    return torch.minimum(torch.maximum(tau, low), up)


def _motor(s: Settings, tau: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    i_des = tau / s.gear / (MOTOR_KT * 1.5)
    bemf = qd * s.gear * MOTOR_KT * 2.0
    v_act = torch.clamp(i_des * MOTOR_R + bemf, -MOTOR_BATTERY_V, MOTOR_BATTERY_V)
    out = s.gear * torch.clamp(1.5 * MOTOR_KT * (v_act - bemf) / MOTOR_R,
                               -MOTOR_TAU_MAX, MOTOR_TAU_MAX)
    return out - MOTOR_DAMPING * qd - MOTOR_FRICTION * torch.sign(qd)


def joint_torque(s: Settings, ptarget, torque_norm_last, q, qd, tau_ff=None, pd_scale=None):
    """PD torque of one substep, (B, 12) each."""
    tau = s.kp * (ptarget - q) - s.kd * qd
    if pd_scale is not None:
        tau = tau * pd_scale
    tau = 0.99 * tau + 0.01 * torque_norm_last
    if tau_ff is not None:
        tau = tau + tau_ff
    if s.motor_dynamics:
        tau = _motor(s, tau, qd)
    return _envelope(s, tau, qd)


# --- kinematics and dynamics -------------------------------------------------

def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).unflatten(-1, (3, 3))


def _quat_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1).unflatten(-1, (3, 3))


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def _ancestors() -> np.ndarray:
    """(13, 18): 1 where dof d moves body b."""
    a = np.zeros((NUM_BODIES, 18))
    a[:, :6] = 1.0
    for b in range(1, NUM_BODIES):
        p = b
        while p > 0:
            a[b, 5 + p] = 1.0
            p = PARENT[p]
    return a


class _Kin(NamedTuple):
    R: torch.Tensor      # (B, 13, 3, 3)
    p: torch.Tensor      # (B, 13, 3)
    com: torch.Tensor    # (B, 13, 3) world
    S: torch.Tensor      # (B, 6, 18) motion subspace, [omega; v at the world origin]
    toe: torch.Tensor    # (B, 4, 3)


def _kinematics(robot: Robot, gc: torch.Tensor) -> _Kin:
    B, dev, dt = gc.shape[0], gc.device, gc.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    R = [_quat_matrix(gc[:, 3:7])]
    p = [gc[:, :3]]
    cols = []
    for j in range(12):
        par = PARENT[j + 1]
        axis = torch.tensor(JOINT_AXIS[j], dtype=dt, device=dev)
        K = _skew(axis)
        th = gc[:, 7 + j, None, None]
        rot = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * mm(K, K)
        anchor = p[par] + mm(R[par], robot.joint_origin[:, j, :, None])[..., 0]
        axis_w = mm(R[par], axis)
        R.append(mm(R[par], rot))
        p.append(anchor)
        cols.append(torch.cat([axis_w, torch.linalg.cross(anchor, axis_w)], dim=-1))
    R, p = torch.stack(R, 1), torch.stack(p, 1)
    com = p + mm(R, robot.com[..., None])[..., 0]
    base_lin = torch.cat([torch.zeros(B, 3, 3, dtype=dt, device=dev), eye.expand(B, 3, 3)], dim=1)
    base_ang = torch.cat([eye.expand(B, 3, 3), _skew(gc[:, :3])], dim=1)
    S = torch.cat([base_lin, base_ang, torch.stack(cols, dim=-1)], dim=-1)
    toe_local = torch.tensor([0.0, 0.0, TOE_OFFSET_Z], dtype=dt, device=dev)
    toe = p[:, SHANKS] + mm(R[:, SHANKS], toe_local)
    return _Kin(R=R, p=p, com=com, S=S, toe=toe)


def _spatial_inertia(robot: Robot, kin: _Kin) -> torch.Tensor:
    """(B, 13, 6, 6) at the world origin."""
    I_w = mm(mm(kin.R, robot.inertia), kin.R.transpose(-1, -2))
    cx = _skew(kin.com)
    m = robot.mass[..., None, None]
    eye = torch.eye(3, device=cx.device).expand(cx.shape)
    top = torch.cat([I_w + m * mm(cx, cx.transpose(-1, -2)), m * cx], dim=-1)
    bot = torch.cat([m * cx.transpose(-1, -2), m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _cross_motion(a, b):
    w1, v1, w2, v2 = a[..., :3], a[..., 3:], b[..., :3], b[..., 3:]
    return torch.cat([torch.linalg.cross(w1, w2),
                      torch.linalg.cross(w1, v2) + torch.linalg.cross(v1, w2)], dim=-1)


def _cross_force(m, f):
    w, v, n, fl = m[..., :3], m[..., 3:], f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, n) + torch.linalg.cross(v, fl),
                      torch.linalg.cross(w, fl)], dim=-1)


def _wrench_at(f, p):
    f, p = torch.broadcast_tensors(f, p)
    return torch.cat([torch.linalg.cross(p, f), f], dim=-1)


def _contact(pos, vel, radius, kn, dn, mu, s: Settings):
    """Penalty contact on flat ground at points (B, k, 3): spring-damper
    normal force; Coulomb friction regularized by tanh, or (impulse mode)
    the force that stops the point within a substep, capped by the cone."""
    pen = torch.clamp_min(radius - pos[..., 2], 0.0)
    vn = vel[..., 2]
    vt = torch.cat([vel[..., :2], torch.zeros_like(vel[..., 2:])], dim=-1)
    fn = torch.clamp_min(kn * pen - dn * vn, 0.0) * (pen > 0.0).float()
    vt_norm = torch.sqrt((vt * vt).sum(-1) + s.slip_vel * s.slip_vel * 1e-4)
    if s.impulse_scale > 0.0:
        ft = torch.minimum(mu * fn, s.impulse_scale * vt_norm)
    else:
        ft = mu * fn * torch.tanh(vt_norm / s.slip_vel)
    normal = torch.cat([torch.zeros_like(vt[..., :2]), fn[..., None]], dim=-1)
    return normal - ft[..., None] * vt / vt_norm[..., None]


def substep(robot: Robot, s: Settings, gc, gv, tau, base_wrench):
    """One semi-implicit Euler substep -> (gc', gv')."""
    dev = gc.device
    kin = _kinematics(robot, gc)
    anc = torch.tensor(_ancestors(), dtype=torch.float32, device=dev)
    I_sp = _spatial_inertia(robot, kin)
    v = ein("bpd,bnd->bnp", kin.S, anc * gv[:, None, :])      # (B,13,6)

    # external wrenches: toes on the shanks, box corners and the base wrench on the base
    kn, dn, mu = robot.kn[:, None], robot.dn[:, None], robot.friction[:, None]
    toe_vel = v[:, SHANKS, 3:] + torch.linalg.cross(v[:, SHANKS, :3], kin.toe)
    f_toe = _contact(kin.toe, toe_vel, TOE_RADIUS, kn, dn, mu, s)
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                         dtype=torch.float32, device=dev) * torch.tensor(BOX_HALF, device=dev)
    corners = kin.p[:, None, 0] + ein("bij,cj->bci", kin.R[:, 0], signs)
    corner_vel = v[:, None, 0, 3:] + torch.linalg.cross(v[:, None, 0, :3].expand_as(corners),
                                                         corners)
    f_box = _contact(corners, corner_vel, 0.0, kn * 0.25, dn * 0.25, mu, s)
    p0 = kin.p[:, 0]
    f_b, n_b = base_wrench[:, :3], base_wrench[:, 3:]
    base = (_wrench_at(f_box, corners).sum(1)
            + torch.cat([n_b + torch.linalg.cross(p0, f_b), f_b], dim=-1))
    f_ext = torch.zeros(gc.shape[0], NUM_BODIES, 6, device=dev)
    f_ext[:, 0] = base
    f_ext[:, list(SHANKS)] = _wrench_at(f_toe, kin.toe)

    # bias accelerations down the tree (qdd = 0): the base's, then S_j's derivative
    acc = [torch.cat([torch.zeros_like(gv[:, :3]),
                      torch.linalg.cross(gv[:, :3], gv[:, 3:6])], dim=-1)]
    for b in range(1, NUM_BODIES):
        par = PARENT[b]
        acc.append(acc[par] + _cross_motion(v[:, par], kin.S[:, :, 5 + b]) * gv[:, 5 + b, None])
    acc = torch.stack(acc, 1)
    grav = torch.tensor(GRAVITY, device=dev) * robot.mass[..., None]
    f_net = (mm(I_sp, acc[..., None])[..., 0] + _cross_force(v, mm(I_sp, v[..., None])[..., 0])
             - _wrench_at(grav, kin.com) - f_ext)
    h = ein("bpd,bnp,nd->bd", kin.S, f_net, anc)

    Sb = kin.S[:, None] * anc[None, :, None, :]                 # (B,13,6,18)
    M = ein("bnpd,bnpq,bnqe->bde", Sb, I_sp, Sb)
    M = 0.5 * (M + M.transpose(-1, -2)) + torch.diag(torch.tensor(
        (0.0,) * 6 + ROTOR_INERTIA, device=dev))
    tau_full = torch.cat([torch.zeros_like(gv[:, :6]), tau - JOINT_DAMPING * gv[:, 6:]], dim=-1)
    L, info = torch.linalg.cholesky_ex(M)
    qdd = torch.cholesky_solve((tau_full - h)[..., None], L)[..., 0]
    qdd = torch.where((info == 0)[:, None], qdd, float("nan"))   # M not positive definite

    gv2 = gv + s.dt * qdd
    w = gv2[:, 3:6]
    angle = torch.sqrt((w * w).sum(-1, keepdim=True))
    half = 0.5 * angle * s.dt
    k = torch.where(angle > 1e-9, torch.sin(half) / torch.clamp_min(angle, 1e-12), 0.5 * s.dt)
    quat = _quat_mul(torch.cat([torch.cos(half), k * w], dim=-1), gc[:, 3:7])
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    gc2 = torch.cat([gc[:, :3] + s.dt * gv2[:, :3], quat, gc[:, 7:] + s.dt * gv2[:, 6:]], -1)
    return gc2, gv2


def control_step(robot: Robot, s: Settings, gc, gv, ptarget, torque_norm_last, base_wrench,
                 tau_ff=None, pd_scale=None):
    """One control step of ``s.n_substeps`` substeps, each after the PD torque
    from the fresh state -> (gc', gv', the last substep's torque)."""
    for _ in range(s.n_substeps):
        tau = joint_torque(s, ptarget, torque_norm_last, gc[:, 7:], gv[:, 6:], tau_ff, pd_scale)
        gc, gv = substep(robot, s, gc, gv, tau, base_wrench)
    return gc, gv, tau

