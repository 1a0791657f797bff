"""Convex single-rigid-body (SRB) trot-MPC, batched over a leading problem axis.

Port of ``mpc/srb.py``: the robot is one rigid body driven by ground-reaction
forces at gait-scheduled footholds, the dynamics are linear time-varying with
analytic A_t/B_t, and the force plan is one affine time-varying-LQR Riccati
sweep followed by a friction-cone projection (Di Carlo et al., IROS 2018).

Every tensor carries a leading problem axis: ``SRBProblem.x0`` is (B, 13),
``SRBResult.forces`` (B, T, 4, 3), and so on; one problem is a batch of one.
The knot matrices of all problems and knots are assembled in one pass; the
Riccati backward sweep and the forward rollout are Python loops over the T
knots of batched (B, 13, 13)/(B, 13, 12) products. The JAX package compiles
the same sweep with XLA and has no Pallas kernel for it, so neither has this
port: it is plain PyTorch.

The solved forces map back to the normalized PD-target sequence the bp5
policy emits (:func:`_grf_to_controls`), and the first knot's forces to joint
torques for the Convert2Torque actuation (:func:`grf_to_torque`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import kinematics as kin
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix

_G = 9.81
NX = 13  # [rpy(3) p(3) omega_world(3) v(3) g-const(1)]
NU = 12  # 4 x GRF


@dataclasses.dataclass(frozen=True)
class SRBConfig:
    """Weights and options of the solve (the JAX package's ``SRBConfig``;
    its notes explain each field)."""
    horizon: int = 50
    w_rpy: tuple = (40.0, 40.0, 20.0)
    w_pos: tuple = (5.0, 5.0, 200.0)
    w_omega: tuple = (1.0, 1.0, 2.0)
    w_vel: tuple = (8.0, 8.0, 2.0)
    r_force: float = 4e-5
    mu: float = 0.6            # friction-cone slope for the projection
    fz_max: float = 120.0      # per-leg normal force bound [N]
    decimation: int = 1        # knot dt = decimation * control_dt
    raibert_gain: float = 0.03  # foothold shift per m/s of (v_meas - v_cmd)
    sweep_mode: str = "command"    # "command", "measured" or "planned"
    sweep_gain: float = 1.0        # scales the sweep pace
    touchdown_match: bool = False  # MPC-grade gait profile (robot.gait.toe_targets)
    accel_ramp: float = 4.0        # feasible acceleration of the velocity reference [m/s^2]


class SRBProblem(NamedTuple):
    x0: torch.Tensor         # (B, 13) initial SRB state (g-const = 1)
    command: torch.Tensor    # (B, 3) [vx, vy, wz]
    t0: torch.Tensor         # (B,) gait clock at the first knot
    yaw0: torch.Tensor       # (B,) current yaw
    v_meas: torch.Tensor     # (B, 2) measured body-frame (vx, vy) for Raibert


class SRBResult(NamedTuple):
    forces: torch.Tensor     # (B, T, 4, 3) world-frame GRFs (cone-projected)
    xs: torch.Tensor         # (B, T+1, 13) predicted SRB trajectory
    us: torch.Tensor | None  # (B, T, 12) normalized PD-target control sequence
    cost: torch.Tensor       # (B,) tracking cost of the projected solution


# --- model constants ------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _srb_constants(abad: float) -> tuple[float, np.ndarray]:
    """(total mass, composite body inertia about the COM at the stand pose),
    in float64 numpy from the nominal model through ``phys_lanes.fk_lanes``."""
    p = mdl.nominal_params(None, "cpu").map(lambda x: x.double()).expand(1)
    P = lanes.params_to_lanes(p)
    g = [torch.tensor([x], dtype=torch.float64) for x in mdl.stand_gc(abad)]
    k = lanes.fk_lanes(P, g)
    m = p.mass[0].numpy()
    com_w = np.array([[float(c) for c in k.com_w[b]] for b in range(mdl.NUM_BODIES)])
    R = np.array([[[float(x) for x in row] for row in k.R[b]] for b in range(mdl.NUM_BODIES)])
    total_m = float(m.sum())
    com = (m[:, None] * com_w).sum(0) / total_m
    I_w = np.einsum("bij,bjk,blk->bil", R, p.inertia[0].numpy(), R)
    I_tot = np.zeros((3, 3))
    for b in range(m.shape[0]):
        r = com_w[b] - com
        I_tot += I_w[b] + m[b] * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
    return total_m, I_tot


@functools.lru_cache(maxsize=64)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant (nested) tuple as a float32 tensor on ``device``, made once,
    so a solve issues no host-to-device copies."""
    return dev_mod.tensor(values, device)


def _rz(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).reshape(yaw.shape + (3, 3))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape + (3,))


def stance_mask(cfg: EnvConfig, t: torch.Tensor) -> torch.Tensor:
    """(..., 4) 1.0 while the gait schedule has the leg in stance at time t (...)."""
    offsets = _const(cfg.phase_offsets, t.device)
    ph = torch.remainder(t[..., None] + offsets * cfg.period, cfg.period) / cfg.period
    return (ph < cfg.lam).to(t.dtype)


def foot_positions_body(cfg: EnvConfig, command: torch.Tensor, t: torch.Tensor,
                        xy_shift: torch.Tensor | None = None,
                        touchdown_match: bool = False) -> torch.Tensor:
    """(B, 4, 3) scheduled foot positions relative to the body center (body
    frame) for commands (B, 3) at times (B,), shifted by xy_shift (B, 2)."""
    toe = gait.toe_targets(cfg, command, t, touchdown_match)
    if xy_shift is not None:
        toe = torch.cat([toe[..., :2] + xy_shift[..., None, :], toe[..., 2:]], dim=-1)
    return toe + _const(tuple(map(tuple, mdl.EE_OFFSET.tolist())), t.device)


def _over_knots(x: torch.Tensor, T: int) -> torch.Tensor:
    """(B, k) per-problem values -> (B * T, k), repeated over the knots."""
    return x[:, None].expand((x.shape[0], T) + x.shape[1:]).reshape((-1,) + x.shape[1:])


def _knot_matrices(cfg: EnvConfig, scfg: SRBConfig, sched_cmd, xy_shift, ts, yaw,
                   m: float, I_inv: torch.Tensor):
    """Analytic [A | B] of every knot of every problem (forward Euler plus the
    exact p <- v coupling) and the stance gating.

    sched_cmd (B, 3), xy_shift (B, 2), ts and yaw (B, T) -> AB (B, T, 13, 25)
    holding A (13, 13) and B (13, 12) side by side, and sm (B, T, 4).
    I_w^-1 = Rz I_body^-1 Rz^T with I_body^-1 precomputed."""
    nb, T = ts.shape
    dev = ts.device
    dt = cfg.control_dt * scfg.decimation
    Rz = _rz(yaw)                                                   # (B,T,3,3)
    I_w_inv = Rz @ I_inv @ Rz.transpose(-1, -2)
    feet = foot_positions_body(cfg, _over_knots(sched_cmd, T), ts.reshape(-1),
                               _over_knots(xy_shift, T), scfg.touchdown_match)
    r = torch.einsum("ntij,ntlj->ntli", Rz, feet.reshape(nb, T, 4, 3))   # (B,T,4,3)
    sm = stance_mask(cfg, ts)                                       # (B,T,4)

    AB = torch.zeros((nb, T, NX, NX + NU), device=dev)
    AB[..., :NX] = torch.eye(NX, device=dev)
    AB[..., 0:3, 6:9] = Rz.transpose(-1, -2) * dt
    AB[..., 3:6, 9:12] = torch.eye(3, device=dev) * dt
    AB[..., 11, 12] = -_G * dt

    gate = (dt * sm)[..., None, :, None]                            # (B,T,1,4,1)
    b_ang = torch.einsum("ntij,ntljk->ntilk", I_w_inv, _skew(r)) * gate
    b_lin = torch.eye(3, device=dev)[:, None, :] / m * gate         # (B,T,3,4,3)
    AB[..., 6:9, NX:] = b_ang.reshape(nb, T, 3, NU)
    AB[..., 9:12, NX:] = b_lin.reshape(nb, T, 3, NU)
    return AB, sm


def _reference_states(cfg: EnvConfig, scfg: SRBConfig, prob: SRBProblem) -> torch.Tensor:
    """(B, T+1, 13) reference trajectory from the command (accel-ramped)."""
    dev = prob.x0.device
    dt = cfg.control_dt * scfg.decimation
    ts = torch.arange(scfg.horizon + 1, dtype=dev_mod.DTYPE, device=dev) * dt
    vx, vy, wz = (prob.command[:, i:i + 1] for i in range(3))
    yaw = prob.yaw0[:, None] + wz * ts
    v_world = torch.stack([vx * torch.cos(yaw) - vy * torch.sin(yaw),
                           vx * torch.sin(yaw) + vy * torch.cos(yaw),
                           torch.zeros_like(yaw)], dim=-1)
    if scfg.accel_ramp > 0.0:
        # decay the initial velocity error at a feasible rate (see SRBConfig)
        e0 = v_world[:, 0] - prob.x0[:, 9:12]
        shrink = torch.clamp_min(torch.abs(e0)[:, None] - scfg.accel_ramp * ts[:, None], 0.0)
        v_world = v_world - torch.sign(e0)[:, None] * shrink
    steps = torch.cat([torch.zeros_like(v_world[:, :1]), v_world[:, :-1] * dt], dim=1)
    p = prob.x0[:, None, 3:6] + torch.cumsum(steps, dim=1)
    p = torch.cat([p[..., :2], torch.full_like(p[..., 2:], cfg.stand_height)], dim=-1)
    zero = torch.zeros_like(yaw)
    rpy = torch.stack([zero, zero, yaw], dim=-1)
    omega = torch.stack([zero, zero, wz.expand_as(yaw)], dim=-1)
    return torch.cat([rpy, p, omega, v_world, torch.ones_like(yaw)[..., None]], dim=-1)


def make_problem(cfg: EnvConfig, gc: torch.Tensor, gv: torch.Tensor,
                 command: torch.Tensor, t0: torch.Tensor) -> SRBProblem:
    """SRB problems from generalized coordinates (B, 19), velocities (B, 18),
    commands (B, 3) and gait clocks (B,)."""
    R = quat_to_matrix(gc[:, 3:7])
    # ZYX euler from R (yaw-pitch-roll)
    yaw = torch.atan2(R[:, 1, 0], R[:, 0, 0])
    pitch = torch.arcsin(-torch.clamp(R[:, 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[:, 2, 1], R[:, 2, 2])
    x0 = torch.cat([torch.stack([roll, pitch, yaw], dim=-1), gc[:, :3], gv[:, 3:6], gv[:, :3],
                    torch.ones_like(yaw)[:, None]], dim=-1)
    v_body = torch.einsum("bji,bj->bi", R, gv[:, :3])
    return SRBProblem(x0=x0, command=command, t0=t0, yaw0=yaw, v_meas=v_body[:, :2])


def _project_cone(f: torch.Tensor, sm: torch.Tensor, mu: float, fz_max: float) -> torch.Tensor:
    """Per-leg friction-cone + unilateral projection. f (..., 4, 3), sm (..., 4)."""
    fz = torch.clamp(f[..., 2:], 0.0, fz_max)
    lim = mu * fz
    fxy = torch.clamp(f[..., :2], -lim, lim)
    return torch.cat([fxy, fz], dim=-1) * sm[..., None]


def sweep_command(cfg: EnvConfig, scfg: SRBConfig, prob: SRBProblem) -> torch.Tensor:
    """(B, 3) velocity that paces the gait schedule (see SRBConfig.sweep_mode).
    Shared by solve() and the closed-loop runtime so the stance-force plan and
    the swing-leg references follow the same schedule."""
    mode = scfg.sweep_mode
    if mode == "measured":
        v = prob.v_meas
    elif mode == "planned":
        t_mid = 0.5 * scfg.horizon * cfg.control_dt * scfg.decimation
        e = prob.command[:, :2] - prob.v_meas
        v = prob.v_meas + torch.sign(e) * torch.clamp_max(torch.abs(e), scfg.accel_ramp * t_mid)
    elif mode == "command":
        v = prob.command[:, :2]
    else:
        raise ValueError(f"unknown sweep_mode {mode!r}")
    return torch.cat([v * scfg.sweep_gain, prob.command[:, 2:3]], dim=-1)


@functools.lru_cache(maxsize=16)
def _solver_consts(cfg: EnvConfig, scfg: SRBConfig, device: torch.device):
    """(m, I_body^-1, diag Q, Q, R + jitter, the column pick [0..12, 25], the
    picked qu column [13]) on ``device``."""
    m, I_body = _srb_constants(cfg.abad)
    t = lambda x: dev_mod.tensor(x, device)  # noqa: E731
    q_diag = np.array(list(scfg.w_rpy) + list(scfg.w_pos) + list(scfg.w_omega)
                      + list(scfg.w_vel) + [0.0])
    pick = torch.tensor(list(range(NX)) + [NX + NU], dtype=torch.long, device=device)
    return (m, t(np.linalg.inv(I_body)), t(q_diag), t(np.diag(q_diag)),
            t((scfg.r_force + 1e-9) * np.eye(NU)), pick, pick[NX:] - NU)


def solve(cfg: EnvConfig, scfg: SRBConfig, prob: SRBProblem,
          controls: bool = True) -> SRBResult:
    """One affine TV-LQR sweep + friction-cone projection + forward rollout
    for every problem of the batch. Raises ``torch.linalg.LinAlgError`` if a
    knot's control Hessian is not positive definite. ``controls=False``
    leaves ``us`` out (None): the torque-control loop reads only the forces.

    A knot of the backward sweep is two products, [A | B]' [V A | V B | v],
    whose B' rows hold Quu - R, Qux and B'v and whose A' rows hold A'VA and
    A'v; one factorization of Quu (with the jitter 1e-9 I) solved for
    [Qux | qu] gives [K | k], and one product Qux' [K | k] updates [V | v]:
    the host issues ~20 PyTorch ops a knot, whatever the batch."""
    dev = prob.x0.device
    nb = prob.x0.shape[0]
    m, I_inv, q_diag, Q, RJ, pick, qu_col = _solver_consts(cfg, scfg, dev)
    T = scfg.horizon
    dt = cfg.control_dt * scfg.decimation
    knots = torch.arange(T, dtype=dev_mod.DTYPE, device=dev)
    ts = prob.t0[:, None] + knots * dt                             # (B,T)
    yaw_ref = prob.yaw0[:, None] + prob.command[:, 2:3] * knots * dt

    xy_shift = scfg.raibert_gain * (prob.v_meas - prob.command[:, :2])
    sched_cmd = sweep_command(cfg, scfg, prob)
    AB, sm = _knot_matrices(cfg, scfg, sched_cmd, xy_shift, ts, yaw_ref, m, I_inv)
    x_ref = _reference_states(cfg, scfg, prob)                     # (B,T+1,13)

    # gravity feedforward: penalize deviation from the weight-sharing force
    n_st = torch.clamp_min(sm.sum(-1), 1.0)                        # (B,T)
    u_ff = torch.stack([torch.zeros_like(sm), torch.zeros_like(sm),
                        sm * (m * _G / n_st)[..., None]], dim=-1).reshape(nb, T, NU)
    qx_ref = -q_diag * x_ref                                       # (B,T+1,13)

    # knot-major, one contiguous (B, ...) tensor a knot: [A | B], its transpose,
    # [Q | -Q x_ref] (the stage terms of [V | v]) and -r u_ff (of qu)
    AB_k = AB.transpose(0, 1).contiguous().unbind(0)
    ABt_k = AB.permute(1, 0, 3, 2).contiguous().unbind(0)
    Qq_k = torch.cat([Q.expand(T, nb, NX, NX), qx_ref[:, :T].transpose(0, 1)[..., None]],
                     dim=-1).unbind(0)
    rff_k = (-scfg.r_force * u_ff).transpose(0, 1)[..., None].unbind(0)
    sm_k = sm.transpose(0, 1).unbind(0)

    # backward: stage cost 1/2 (x-xr)'Q(x-xr) + 1/2 (u-uf)'R(u-uf)
    V, v = Q.expand(nb, NX, NX), qx_ref[:, T, :, None]
    sols, infos = [None] * T, []
    for t in reversed(range(T)):
        M = torch.bmm(ABt_k[t], torch.cat([torch.bmm(V, AB_k[t]), v], dim=-1))   # (B,25,26)
        Mb = M[:, NX:]                                       # [Qux | B'VB | B'v]
        L, info = torch.linalg.cholesky_ex(Mb[..., NX:NX + NU] + RJ)
        infos.append(info)
        rhs = torch.index_select(Mb, -1, pick).index_add_(-1, qu_col, rff_k[t])  # [Qux | qu]
        sol = torch.cholesky_solve(rhs, L)                                          # [K | k]
        Vv = (Qq_k[t] + torch.index_select(M[:, :NX], -1, pick)
              - torch.bmm(Mb[..., :NX].transpose(-1, -2), sol))
        V, v = Vv[..., :NX], Vv[..., NX:]
        V = 0.5 * (V + V.transpose(-1, -2))
        sols[t] = sol
    linalg.check_factorized(torch.stack(infos), "srb.solve Riccati sweep")

    # forward: u = -(K x + k) = -[K | k] [x; 1], projected; x' = [A | B] [x; f]
    x, one = prob.x0[..., None], torch.ones((nb, 1, 1), device=dev)
    forces, xs = [], [x]
    for t in range(T):
        u = torch.bmm(sols[t], torch.cat([x, one], dim=1))
        f = _project_cone(-u.view(nb, 4, 3), sm_k[t], scfg.mu, scfg.fz_max)
        x = torch.bmm(AB_k[t], torch.cat([x, f.view(nb, NU, 1)], dim=1))
        forces.append(f)
        xs.append(x)
    forces, xs = torch.stack(forces, dim=1), torch.stack(xs, dim=1)[..., 0]

    err = xs - x_ref
    cost = 0.5 * (q_diag * err * err).sum(dim=(1, 2)) * dt
    us = _grf_to_controls(cfg, sched_cmd, xy_shift, ts, forces, sm, yaw_ref,
                          scfg.touchdown_match) if controls else None
    return SRBResult(forces=forces, xs=xs, us=us, cost=cost)


# ``solve`` takes a batch already; the JAX package's vmapped name stays for its callers
batched_solve = solve


def _pd_gains(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    return _const(tuple((np.array([cfg.abad_ratio, 1.0, 1.0] * 4) * cfg.stiffness).tolist()),
                  device)


def _grf_to_controls(cfg: EnvConfig, command, xy_shift, ts, forces, sm, yaw_ref,
                     touchdown_match: bool = False) -> torch.Tensor:
    """GRF plan -> (B, T, 12) normalized PD-target sequence comparable to bp5
    actions. Swing legs: the gait reference (u = q_ref - stand). Stance legs
    add the torque-feedforward admittance tau/kp with tau = -J(q_ref)' R_b' f."""
    nb, T = ts.shape
    dev = ts.device
    stand = _const(tuple(mdl.stand_gc(cfg.abad)[7:].tolist()), dev)
    q_ref = gait.gait_reference(cfg, _over_knots(command, T), ts.reshape(-1),
                                _over_knots(xy_shift, T), touchdown_match).joint_ref
    f_body = torch.einsum("nij,nli->nlj", _rz(yaw_ref.reshape(-1)), forces.reshape(-1, 4, 3))
    J = kin.legs_jacobian(q_ref)                                    # (B*T,4,3,3)
    tau = -torch.einsum("nlij,nli->nlj", J, f_body) * sm.reshape(-1, 4, 1)
    us = (q_ref - stand) + tau.reshape(-1, NU) / _pd_gains(cfg, dev)
    return us.reshape(nb, T, NU)


def grf_to_torque(cfg: EnvConfig, gc: torch.Tensor, f_world: torch.Tensor,
                  sm: torch.Tensor, stance_pd: float = 0.0,
                  swing_pd: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Convert2Torque: the first knot's GRF plan (B, 4, 3) -> direct joint
    torques. Stance legs: tau = -J(q)' R' f at the measured joint angles and
    body orientation of gc (B, 19); swing legs keep full PD. Returns
    ``(tau_ff (B, 12), pd_scale (B, 12))`` for envs.blackpanther.step_batch;
    ``stance_pd`` leaves that fraction of PD feedback on stance legs."""
    R = quat_to_matrix(gc[:, 3:7])
    f_body = torch.einsum("bij,bli->blj", R, f_world)              # R^T f: world->body
    J = kin.legs_jacobian(gc[:, 7:])                                # (B,4,3,3)
    tau = -torch.einsum("blij,bli->blj", J, f_body) * sm[..., None]
    pd_scale = torch.repeat_interleave(swing_pd - (swing_pd - stance_pd) * sm, 3, dim=-1)
    return tau.reshape(-1, NU), pd_scale


def standing_problem(cfg: EnvConfig, command: torch.Tensor,
                     t0: torch.Tensor | None = None) -> SRBProblem:
    """Problems (B,) from rest at the stand height for commands (B, 3)."""
    nb, dev = command.shape[0], command.device
    x0 = torch.zeros((nb, NX), device=dev)
    x0[:, 5] = cfg.stand_height
    x0[:, 12] = 1.0
    zero = torch.zeros(nb, device=dev)
    return SRBProblem(x0=x0, command=command, t0=zero if t0 is None else t0, yaw0=zero,
                      v_meas=command[:, :2])
