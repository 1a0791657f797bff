"""Plain PyTorch convex single-rigid-body trot-MPC (Di Carlo et al., IROS 2018).

The benchmark's yardstick for the port's ``mpc/srb`` and the Convert2Torque
map: the robot as one rigid body under ground-reaction forces at
gait-scheduled footholds, linear time-varying dynamics (forward Euler with the
exact p <- v coupling), a quadratic tracking cost, one affine TV-LQR Riccati
sweep solved exactly, the first knot's forces projected on the friction cone
and mapped to joint torques through the legs' Jacobians. Written from those
equations; nothing here imports the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from irrl_bench.reference import physics
from irrl_bench.reference.numerics import mm

G = 9.81
NX, NU = 13, 12
# gait and leg constants (Environment.hpp:1949-1952 as the port states them)
L_HIP, L_THIGH, L_CALF = 0.085, 0.209, 0.2175
EE_OFFSET = ((0.19, -0.058, 0.0), (0.19, 0.058, 0.0), (-0.19, -0.058, 0.0), (-0.19, 0.058, 0.0))
IS_RIGHT = (True, False, True, False)
PHASE_OFFSETS = {0: (0.5, 0.0, 0.0, 0.5), 1: (0.5, 0.5, 0.0, 0.0), 2: (0.0, 0.25, 0.5, 0.75)}
STAND_Q = (0.0, -0.78, 1.57) * 4
STAND_Z = 0.35


def nominal_robot(device) -> physics.Robot:
    """The 13-body model of black_panther.urdf (toes merged into the shanks)."""
    masses, coms, inertias, origins = [3.72], [(0.0, 0.0, -0.003)], \
        [np.diag([0.016269, 0.050813, 0.060989])], []
    for sx, sy in ((1, -1), (1, 1), (-1, -1), (-1, 1)):
        sh_m, sh_c, sh_i = 0.064, np.array([0.0, 0.0, -0.0865]), np.diag([0.000716, 0.000721,
                                                                             0.000012])
        toe_m, toe_c, toe_i = 0.05, np.array([0.0, 0.0, physics.TOE_OFFSET_Z]), np.eye(3) * 2.5e-5
        m = sh_m + toe_m
        c = (sh_m * sh_c + toe_m * toe_c) / m
        shift = lambda i, mm, ci: i + mm * (np.dot(ci - c, ci - c) * np.eye(3)  # noqa: E731
                                            - np.outer(ci - c, ci - c))
        masses += [0.54, 0.636, m]
        coms += [(0.058 * sx, 0.00485 * sy, 0.0), (0.0, -0.019 * sy, -0.01865), tuple(c)]
        inertias += [np.diag([0.000391, 0.000739, 0.000488]),
                     np.array([[0.001724, 0.0, 0.0], [0.0, 0.001907, -0.000228 * sy],
                               [0.0, -0.000228 * sy, 0.000468]]),
                     shift(sh_i, sh_m, sh_c) + shift(toe_i, toe_m, toe_c)]
        origins += [(0.212 * sx, 0.051 * sy, 0.0), (0.0, 0.085 * sy, 0.0), (0.0, 0.0, -0.201)]
    t = lambda x: torch.tensor(np.array(x), dtype=torch.float64, device=device)[None]  # noqa: E731
    one = torch.ones(1, dtype=torch.float64, device=device)
    return physics.Robot(mass=t(masses), com=t(coms), inertia=t(inertias),
                         joint_origin=t(origins), friction=one, kn=one, dn=one)


def body_constants(device) -> tuple[float, torch.Tensor]:
    """(total mass, composite inertia about the COM at the stand pose)."""
    robot = nominal_robot(device)
    gc = torch.tensor([[0.0, 0.0, STAND_Z, 1.0, 0.0, 0.0, 0.0, *STAND_Q]], dtype=torch.float64,
                      device=device)
    kin = physics._kinematics(robot, gc)
    m = robot.mass[0]
    com = (m[:, None] * kin.com[0]).sum(0) / m.sum()
    I_w = mm(mm(kin.R[0], robot.inertia[0]), kin.R[0].transpose(-1, -2))
    r = kin.com[0] - com
    eye = torch.eye(3, dtype=torch.float64, device=device)
    I_tot = (I_w + m[:, None, None] * ((r * r).sum(-1)[:, None, None] * eye
                                       - r[:, :, None] * r[:, None, :])).sum(0)
    return float(m.sum()), I_tot


class Settings(NamedTuple):
    horizon: int
    dt: float
    q_diag: tuple
    r_force: float
    mu: float
    fz_max: float
    raibert_gain: float
    sweep_gain: float
    accel_ramp: float
    period: float
    lam: float
    stand_height: float
    up_height: float
    height_variable: bool
    vmax: tuple            # (vx, vy, omega) maxima of the HeightVariable scaling
    wildcat: bool
    offsets: tuple


def settings(env: dict, srb: dict) -> Settings:
    if srb["sweep_mode"] != "command" or not srb["touchdown_match"] or srb["decimation"] != 1:
        raise ValueError("the reference solves the command-paced, touchdown-matched problem "
                         "at the control rate")
    return Settings(
        horizon=int(srb["horizon"]), dt=float(env["control_dt"]),
        q_diag=tuple(srb["w_rpy"]) + tuple(srb["w_pos"]) + tuple(srb["w_omega"])
        + tuple(srb["w_vel"]) + (0.0,),
        r_force=float(srb["r_force"]), mu=float(srb["mu"]), fz_max=float(srb["fz_max"]),
        raibert_gain=float(srb["raibert_gain"]), sweep_gain=float(srb["sweep_gain"]),
        accel_ramp=float(srb["accel_ramp"]), period=float(env["period"]),
        lam=float(env["lam"]), stand_height=float(env["stand_height"]),
        up_height=float(env["up_height"]), height_variable=bool(env["HeightVariable"]),
        vmax=(float(env["Vx"]), float(env["Vy"]), float(env["Omega"])),
        wildcat=bool(env["WILDCAT"]), offsets=PHASE_OFFSETS[int(env["GaitType"])])


def _rot_z(yaw):
    c, s, z, o = torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).unflatten(-1, (3, 3))


def _phase(s: Settings, t):
    off = torch.tensor(s.offsets, dtype=t.dtype, device=t.device)
    return torch.remainder(t[..., None] + off * s.period, s.period) / s.period


def stance(s: Settings, t):
    """(..., 4) 1 where the schedule has the leg in stance at time t."""
    return (_phase(s, t) < s.lam).to(t.dtype)


def _blend(x):
    return x ** 3 + 3.0 * x ** 2 * (1.0 - x)


def toe_targets(s: Settings, cmd, t):
    """(..., 4, 3) hip-frame toe targets of the touchdown-matched profile:
    a linear stance sweep, a Bezier swing with a Gaussian apex and a late
    retraction that lands the foot at the stance sweep's rate."""
    step = cmd[..., 0] * s.lam * s.period * (-1.0 if s.wildcat else 1.0)
    side = cmd[..., 1] * s.lam * s.period
    rot = cmd[..., 2] * s.period * 0.4
    if s.height_variable:
        ratio = torch.abs(cmd[..., 0]) / s.vmax[0]
        if s.vmax[1] > 0:
            ratio = torch.maximum(ratio, torch.abs(cmd[..., 1]) / s.vmax[1])
        if s.vmax[2] > 0:
            ratio = torch.maximum(ratio, torch.abs(cmd[..., 2] / s.vmax[2]))
        up = torch.where(ratio > 0.1, torch.full_like(ratio, s.up_height), ratio * s.up_height)
    else:
        up = torch.full_like(step, s.up_height)
    ph = _phase(s, t)
    anti = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=t.dtype, device=t.device)
    fwd = torch.stack([(step / 2)[..., None].expand(ph.shape),
                       side[..., None] / 2 + anti * rot[..., None] / 2,
                       torch.full_like(ph, -s.stand_height)], dim=-1)
    back = torch.stack([-fwd[..., 0], -fwd[..., 1], fwd[..., 2]], dim=-1)
    r_st, r_sw = ph / s.lam, (ph - s.lam) / (1.0 - s.lam)
    toe_st = fwd + torch.clamp(r_st, 0.0, 1.0)[..., None] * (back - fwd)
    xy = back[..., :2] + _blend(r_sw)[..., None] * (fwd[..., :2] - back[..., :2])
    u = torch.clamp((r_sw - 0.8) / 0.2, 0.0, 1.0)[..., None]
    xy = xy - 0.1 * (fwd[..., :2] - back[..., :2]) * (1.0 - s.lam) / s.lam * u ** 2
    z = back[..., 2] + up[..., None] * torch.exp(-((r_sw - 0.5) ** 2) / (2.0 / 36.0))
    toe_sw = torch.cat([xy, z[..., None]], dim=-1)
    return torch.where((ph < s.lam)[..., None], toe_st, toe_sw)


class Problem(NamedTuple):
    x0: torch.Tensor       # (B, 13) [rpy, p, omega, v, 1]
    command: torch.Tensor  # (B, 3)
    t0: torch.Tensor       # (B,)
    yaw0: torch.Tensor     # (B,)
    v_meas: torch.Tensor   # (B, 2) body-frame velocity


def make_problem(gc, gv, command, t0) -> Problem:
    R = physics._quat_matrix(gc[:, 3:7])
    yaw = torch.atan2(R[:, 1, 0], R[:, 0, 0])
    pitch = torch.asin(-torch.clamp(R[:, 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[:, 2, 1], R[:, 2, 2])
    x0 = torch.cat([torch.stack([roll, pitch, yaw], -1), gc[:, :3], gv[:, 3:6], gv[:, :3],
                    torch.ones_like(yaw)[:, None]], dim=-1)
    v_body = mm(R.transpose(-1, -2), gv[:, :3, None])[..., 0]
    return Problem(x0, command, t0, yaw, v_body[:, :2])


class Solution(NamedTuple):
    forces: torch.Tensor   # (B, T, 4, 3) cone-projected
    cost: torch.Tensor     # (B,)


def solve(s: Settings, prob: Problem, mass: float, I_body: torch.Tensor) -> Solution:
    B, T, dev = prob.x0.shape[0], s.horizon, prob.x0.device
    dt = s.dt
    k = torch.arange(T, dtype=torch.float32, device=dev) * dt
    ts = prob.t0[:, None] + k
    yaw_ref = prob.yaw0[:, None] + prob.command[:, 2:3] * k
    shift = s.raibert_gain * (prob.v_meas - prob.command[:, :2])
    sched = torch.cat([prob.command[:, :2] * s.sweep_gain, prob.command[:, 2:3]], dim=-1)
    feet = toe_targets(s, sched[:, None].expand(B, T, 3), ts)
    feet = torch.cat([feet[..., :2] + shift[:, None, None], feet[..., 2:]], dim=-1)
    feet = feet + torch.tensor(EE_OFFSET, device=dev)
    Rz = _rot_z(yaw_ref)                                                # (B,T,3,3)
    r = mm(Rz[:, :, None], feet[..., None])[..., 0]                      # (B,T,4,3)
    sm = stance(s, ts)                                                  # (B,T,4)
    I_inv = mm(mm(Rz, torch.linalg.inv(I_body).float()), Rz.transpose(-1, -2))

    A = torch.eye(NX, device=dev).expand(B, T, NX, NX).clone()
    A[..., 0:3, 6:9] = Rz.transpose(-1, -2) * dt
    A[..., 3:6, 9:12] = torch.eye(3, device=dev) * dt
    A[..., 11, 12] = -G * dt
    Bm = torch.zeros(B, T, NX, NU, device=dev)
    for leg in range(4):
        gate = (dt * sm[..., leg])[..., None, None]
        Bm[..., 6:9, 3 * leg:3 * leg + 3] = mm(I_inv, physics._skew(r[:, :, leg])) * gate
        Bm[..., 9:12, 3 * leg:3 * leg + 3] = torch.eye(3, device=dev) / mass * gate

    # the reference trajectory, its velocity error decayed at a feasible rate
    tk = torch.arange(T + 1, dtype=torch.float32, device=dev) * dt
    vx, vy, wz = (prob.command[:, i:i + 1] for i in range(3))
    yaw = prob.yaw0[:, None] + wz * tk
    vw = torch.stack([vx * torch.cos(yaw) - vy * torch.sin(yaw),
                      vx * torch.sin(yaw) + vy * torch.cos(yaw), torch.zeros_like(yaw)], -1)
    e0 = vw[:, 0] - prob.x0[:, 9:12]
    vw = vw - torch.sign(e0)[:, None] * torch.clamp_min(
        torch.abs(e0)[:, None] - s.accel_ramp * tk[:, None], 0.0)
    p = prob.x0[:, None, 3:6] + torch.cumsum(
        torch.cat([torch.zeros_like(vw[:, :1]), vw[:, :-1] * dt], 1), 1)
    p = torch.cat([p[..., :2], torch.full_like(p[..., 2:], s.stand_height)], -1)
    zero = torch.zeros_like(yaw)
    x_ref = torch.cat([torch.stack([zero, zero, yaw], -1), p,
                       torch.stack([zero, zero, wz.expand_as(yaw)], -1), vw,
                       torch.ones_like(yaw)[..., None]], -1)          # (B,T+1,13)

    # cost: 1/2 (x - x_ref)' Q (x - x_ref) + 1/2 (u - u_ff)' R (u - u_ff), u_ff the
    # weight shared over the stance legs; value V(x) = 1/2 x'Vx + v'x
    Q = torch.diag(torch.tensor(s.q_diag, device=dev))
    Rr = (s.r_force + 1e-9) * torch.eye(NU, device=dev)
    n_st = torch.clamp_min(sm.sum(-1), 1.0)
    u_ff = torch.stack([torch.zeros_like(sm), torch.zeros_like(sm),
                        sm * (mass * G / n_st)[..., None]], -1).reshape(B, T, NU)
    V = Q.expand(B, NX, NX)
    v = -mm(Q, x_ref[:, T, :, None])
    gains = [None] * T
    for t in reversed(range(T)):
        At, Bt = A[:, t], Bm[:, t]
        Quu = mm(mm(Bt.transpose(-1, -2), V), Bt) + Rr
        Qux = mm(mm(Bt.transpose(-1, -2), V), At)
        qu = mm(Bt.transpose(-1, -2), v) - s.r_force * u_ff[:, t, :, None]
        K = torch.linalg.solve(Quu, Qux)
        kk = torch.linalg.solve(Quu, qu)
        V = Q + mm(mm(At.transpose(-1, -2), V), At) - mm(Qux.transpose(-1, -2), K)
        V = 0.5 * (V + V.transpose(-1, -2))
        v = (-mm(Q, x_ref[:, t, :, None]) + mm(At.transpose(-1, -2), v)
             - mm(Qux.transpose(-1, -2), kk))
        gains[t] = (K, kk)
    x = prob.x0[..., None]
    forces, xs = [], [x]
    for t in range(T):
        K, kk = gains[t]
        f = -(mm(K, x) + kk).reshape(B, 4, 3)
        fz = torch.clamp(f[..., 2:], 0.0, s.fz_max)
        lim = s.mu * fz
        f = torch.cat([torch.clamp(f[..., :2], -lim, lim), fz], -1) * sm[:, t, :, None]
        x = mm(A[:, t], x) + mm(Bm[:, t], f.reshape(B, NU, 1))
        forces.append(f)
        xs.append(x)
    err = torch.stack(xs, 1)[..., 0] - x_ref
    q = torch.tensor(s.q_diag, device=dev)
    cost = 0.5 * (q * err * err).sum(dim=(1, 2)) * dt
    return Solution(torch.stack(forces, 1), cost)


def leg_jacobians(q):
    """(B, 12) joint angles -> (B, 4, 3, 3) d toe / d q in the hip frames."""
    q = q.unflatten(-1, (4, 3))
    q0, q1, q2 = q.unbind(-1)
    sy = torch.tensor([-1.0 if r else 1.0 for r in IS_RIGHT], device=q.device)
    s1, c1, s12, c12 = torch.sin(q1), torch.cos(q1), torch.sin(q1 + q2), torch.cos(q1 + q2)
    c0, s0 = torch.cos(q0), torch.sin(q0)
    pz = -(L_THIGH * c1 + L_CALF * c12)
    dx1, dx2 = L_THIGH * c1 + L_CALF * c12, L_CALF * c12
    dz1, dz2 = L_THIGH * s1 + L_CALF * s12, L_CALF * s12
    z = torch.zeros_like(q0)
    rows = [[z, dx1, dx2], [-sy * L_HIP * s0 - pz * c0, -dz1 * s0, -dz2 * s0],
            [sy * L_HIP * c0 - pz * s0, dz1 * c0, dz2 * c0]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def grf_to_torque(gc, f_world, sm, stance_pd: float, swing_pd: float):
    """Stance legs' joint torques -J' R' f at the measured pose; the PD
    feedback's scale by leg (Convert2Torque) -> (tau_ff, pd_scale), (B, 12)."""
    R = physics._quat_matrix(gc[:, 3:7])
    f_body = mm(R.transpose(-1, -2)[:, None], f_world[..., None])[..., 0]   # (B,4,3)
    J = leg_jacobians(gc[:, 7:])
    tau = -mm(J.transpose(-1, -2), f_body[..., None])[..., 0] * sm[..., None]
    scale = (swing_pd - (swing_pd - stance_pd) * sm).repeat_interleave(3, -1)
    return tau.reshape(-1, NU), scale

