"""Articulated rigid-body dynamics of the BlackPanther quadruped, batched over
leading dims.

Port of ``phys/dynamics.py``: CRBA + RNEA in world-origin spatial
coordinates (:mod:`.spatial`); the 13-body tree's recursions run over the 3
levels of a leg with the 4 legs side by side, each body's arithmetic the JAX
package's. Where the JAX package writes one environment and ``vmap``s it,
every function here takes states with any leading dims (``gc`` (..., 19),
``gv`` (..., 18)); :class:`~.model.RobotParams` leaves either have no
leading dims (one robot for all) or leading dims that broadcast against the
state's (per-problem robots).

This is the dense per-env physics that the whole-body MPC's ``make_dynamics``
and frozen linearizer run, and the substep of the per-env
``envs.blackpanther.step`` (compliant contact, or hard contact through
:func:`substep_hard`); it is plain PyTorch because the JAX package computes
it outside any Pallas kernel. ``step_batch``'s substep is the batch-in-lanes
kernel of ``ops/phys_cuda.py``.

The JAX package pins float32 matmul precision in here (``_full_precision``);
the port computes in float32 with TF32 off everywhere (:mod:`..device`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import contact as ct
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import hard_contact as hc
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import spatial as sp
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import (
    JOINT_DAMPING, NUM_BODIES, RobotParams, SHANK_BODY_IDX, TOE_OFFSET_Z, TOE_RADIUS,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import (
    quat_integrate, quat_to_matrix,
)

GRAVITY = (0.0, 0.0, -9.81)
_SHANK = [int(b) for b in SHANK_BODY_IDX]
# bodies 3, 6, 9, 12 as a slice: indexing by a list would copy an index tensor
# to the device at every call (and cannot be captured in a CUDA graph)
SHANKS = slice(3, None, 3)
# leaf -> number of trailing (per-robot) dims of a RobotParams field
_PARAM_DIMS = {"mass": 1, "com": 2, "inertia": 3, "joint_origin": 2, "friction": 0,
               "restitution": 0, "res_threshold": 0, "contact_stiffness": 0,
               "contact_damping": 0}


class _Consts(NamedTuple):
    axis: torch.Tensor      # (12, 3) joint axes in the parent frame
    K: torch.Tensor         # (12, 3, 3) skew(axis)
    KK: torch.Tensor        # (12, 3, 3) skew(axis) @ skew(axis)
    anc: torch.Tensor       # (13, 18) ancestor-dof mask
    rotor: torch.Tensor     # (18, 18) rotor inertias on the joint diagonal
    gravity: torch.Tensor   # (3,)
    toe_local: torch.Tensor  # (3,)
    eye3: torch.Tensor
    lin_cols: torch.Tensor  # (6, 3) motion subspace of the base's linear dofs


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> _Consts:
    t = lambda x: dev_mod.tensor(x, device)  # noqa: E731
    axis = t(mdl.JAXIS)
    K = sp.skew(axis)
    rotor = torch.zeros(18, device=device, dtype=dev_mod.DTYPE)
    rotor[6:] = t(mdl.ROTOR_INERTIA)
    eye3 = torch.eye(3, device=device, dtype=dev_mod.DTYPE)
    return _Consts(axis=axis, K=K, KK=K @ K, anc=t(mdl.ANC_MASK), rotor=torch.diag(rotor),
                   gravity=t(GRAVITY), toe_local=t([0.0, 0.0, TOE_OFFSET_Z]), eye3=eye3,
                   lin_cols=torch.cat([torch.zeros_like(eye3), eye3], dim=0))


def broadcast_params(params: RobotParams, batch: torch.Size) -> RobotParams:
    """Expand (views) every leaf to ``batch`` + its per-robot shape."""
    def leaf(name):
        x = getattr(params, name)
        tail = x.shape[x.dim() - _PARAM_DIMS[name]:]
        return x.expand(tuple(batch) + tuple(tail))
    return RobotParams(**{name: leaf(name) for name in _PARAM_DIMS})


class Kinematics(NamedTuple):
    R: torch.Tensor        # (..., 13, 3, 3) body->world rotations
    p: torch.Tensor        # (..., 13, 3) body frame origins (world)
    com_w: torch.Tensor    # (..., 13, 3) world com positions
    S: torch.Tensor        # (..., 6, 18) joint motion subspace (world-origin coords)
    toe_pos: torch.Tensor  # (..., 4, 3) toe sphere centers (world)


def fk(params: RobotParams, gc: torch.Tensor) -> Kinematics:
    """Forward kinematics. gc: (..., 19).

    The tree's 12 joints are 4 legs of 3, so the recursion runs over the 3
    levels of a leg with the legs side by side: each body's arithmetic is the
    JAX package's, batched over legs."""
    c = _consts(gc.device)
    batch = gc.shape[:-1]
    params = broadcast_params(params, batch)
    base_p = gc[..., :3]
    base_R = quat_to_matrix(gc[..., 3:7])
    q = gc[..., 7:]

    s, co = torch.sin(q)[..., None, None], torch.cos(q)[..., None, None]
    rot = (c.eye3 + s * c.K + (1.0 - co) * c.KK).unflatten(-3, (4, 3))   # (...,4,3,3,3) Rodrigues
    origin = params.joint_origin.unflatten(-2, (4, 3))                    # (...,4,3,3)
    axis = c.axis.unflatten(-2, (4, 3))                                   # (4,3,3)
    Rp, pp = base_R[..., None, :, :], base_p[..., None, :]
    Rs, ps, axes_w = [], [], []
    for level in range(3):
        anchor = pp + (Rp @ origin[..., level, :, None])[..., 0]          # (...,4,3)
        axes_w.append((Rp @ axis[:, level, :, None])[..., 0])
        Rp, pp = Rp @ rot[..., level, :, :], anchor
        Rs.append(Rp)
        ps.append(anchor)
    # bodies 1.. in joint order 3 * leg + level
    R = torch.cat([base_R[..., None, :, :],
                   torch.stack(Rs, dim=-3).flatten(-4, -3)], dim=-3)       # (...,13,3,3)
    p = torch.cat([base_p[..., None, :], torch.stack(ps, dim=-2).flatten(-3, -2)], dim=-2)
    axis_w = torch.stack(axes_w, dim=-2).flatten(-3, -2)                  # (...,12,3)
    anchor = p[..., 1:, :]                                                # (...,12,3)
    com_w = p + (R @ params.com[..., None])[..., 0]

    # motion subspace columns, world-origin coords [omega; v_O]
    lin_cols = c.lin_cols.expand(batch + (6, 3))
    ang_cols = torch.cat([c.eye3.expand(batch + (3, 3)), sp.skew(base_p)], dim=-2)
    joint_cols = torch.cat([axis_w, torch.cross(anchor, axis_w, dim=-1)], dim=-1)
    S = torch.cat([lin_cols, ang_cols, joint_cols.transpose(-1, -2)], dim=-1)   # (...,6,18)

    toe_pos = ps[2] + (Rs[2] @ c.toe_local)
    return Kinematics(R=R, p=p, com_w=com_w, S=S, toe_pos=toe_pos)


def body_velocities(kin: Kinematics, gv: torch.Tensor) -> torch.Tensor:
    """Spatial velocity [omega; v_O] of each body: (..., 13, 6)."""
    anc = _consts(gv.device).anc
    return torch.einsum("...pd,...bd->...bp", kin.S, anc * gv[..., None, :])


def spatial_inertias(params: RobotParams, kin: Kinematics) -> torch.Tensor:
    """(..., 13, 6, 6) world-origin spatial inertias."""
    params = broadcast_params(params, kin.p.shape[:-2])
    I_w = kin.R @ params.inertia @ kin.R.transpose(-1, -2)
    return sp.spatial_inertia(params.mass, kin.com_w, I_w)


def mass_matrix(params: RobotParams, kin: Kinematics) -> torch.Tensor:
    """(..., 18, 18) joint-space mass matrix (CRBA as one masked contraction),
    with the URDF rotor inertias on the joint diagonal."""
    c = _consts(kin.S.device)
    I_sp = spatial_inertias(params, kin)
    Sm = kin.S[..., None, :, :] * c.anc[:, None, :]            # (...,13,6,18)
    M = torch.einsum("...bpd,...bpq,...bqe->...de", Sm, I_sp, Sm)
    M = 0.5 * (M + M.transpose(-1, -2))  # scrub float32 asymmetry before the solve
    return M + c.rotor


def bias_forces(params: RobotParams, kin: Kinematics, gv: torch.Tensor,
                f_ext: torch.Tensor) -> torch.Tensor:
    """Generalized bias h(q, qd) - tau_ext: Coriolis/centrifugal + gravity
    minus the external world-origin wrenches f_ext (..., 13, 6). RNEA with
    qdd = 0, using Sdot_j = v_parent(j) x S_j."""
    c = _consts(gv.device)
    params = broadcast_params(params, gv.shape[:-1])
    I_sp = spatial_inertias(params, kin)
    v = body_velocities(kin, gv)                              # (...,13,6)

    # bias accelerations down the tree, the 4 legs side by side
    v_lin, omega = gv[..., :3], gv[..., 3:6]
    a_base = torch.cat([torch.zeros_like(v_lin), torch.cross(v_lin, omega, dim=-1)], dim=-1)
    v_legs = v[..., 1:, :].unflatten(-2, (4, 3))                          # (...,4,3,6)
    S_legs = kin.S[..., :, 6:].transpose(-1, -2).unflatten(-2, (4, 3))    # (...,4,3,6)
    qd_legs = gv[..., 6:].unflatten(-1, (4, 3))                           # (...,4,3)
    a_par, v_par, a_legs = a_base[..., None, :], v[..., :1, :].expand_as(v_legs[..., 0, :]), []
    for level in range(3):
        a_par = a_par + sp.cross_motion(v_par, S_legs[..., level, :]) * qd_legs[..., level, None]
        v_par = v_legs[..., level, :]
        a_legs.append(a_par)
    a = torch.cat([a_base[..., None, :], torch.stack(a_legs, dim=-2).flatten(-3, -2)],
                  dim=-2)                                                 # (...,13,6)

    Iv = (I_sp @ v[..., None])[..., 0]
    f_grav = sp.force_at_point(c.gravity * params.mass[..., None], kin.com_w)
    f_net = (I_sp @ a[..., None])[..., 0] + sp.cross_force(v, Iv) - f_grav - f_ext
    return torch.einsum("...pd,...bp,bd->...d", kin.S, f_net, c.anc)


class StepDiagnostics(NamedTuple):
    toe_pos: torch.Tensor           # (..., 4, 3)
    toe_vel: torch.Tensor           # (..., 4, 3)
    toe_force_norm: torch.Tensor    # (..., 4) |contact force| [N]
    toe_normal_force: torch.Tensor  # (..., 4)
    torque: torch.Tensor            # (..., 12) applied joint torque after clamp


def _scalar(x: torch.Tensor) -> torch.Tensor:
    """A per-robot scalar field against the (..., k) contact points."""
    return x[..., None]


def contact_wrenches(params: RobotParams, kin: Kinematics, gv: torch.Tensor, tp,
                     slip_vel: float, impulse_scale: float = 0.0):
    """External world-origin wrenches from toe + base-box contact.

    Returns (f_ext (..., 13, 6), toe force norms (..., 4), toe normal forces
    (..., 4), toe velocities (..., 4, 3)). ``tp``: None for flat ground, or a
    terrain of :mod:`.terrain` (see :mod:`.contact`)."""
    params = broadcast_params(params, gv.shape[:-1])
    kn, dn, mu = (_scalar(params.contact_stiffness), _scalar(params.contact_damping),
                  _scalar(params.friction))
    v = body_velocities(kin, gv)
    toe_vel = sp.point_velocity(v[..., SHANKS, :], kin.toe_pos)
    toe_f, toe_fn = ct.point_contact_force(kin.toe_pos, toe_vel, TOE_RADIUS, tp, kn, dn, mu,
                                           slip_vel, impulse_scale)

    corners = ct.box_corner_points(kin.R[..., 0, :, :], kin.p[..., 0, :])   # (...,8,3)
    corner_vel = sp.point_velocity(v[..., 0:1, :], corners)
    # the box face (not a sphere) touches the ground: radius 0, lower stiffness
    box_f, _ = ct.point_contact_force(corners, corner_vel, 0.0, tp, kn * 0.25, dn * 0.25,
                                      mu, slip_vel, impulse_scale)

    toe_w = sp.force_at_point(toe_f, kin.toe_pos)                      # (...,4,6)
    rows = [torch.sum(sp.force_at_point(box_f, corners), dim=-2)]
    zero = torch.zeros_like(rows[0])
    for b in range(1, NUM_BODIES):
        rows.append(toe_w[..., _SHANK.index(b), :] if b in _SHANK else zero)
    f_ext = torch.stack(rows, dim=-2)
    toe_force_norm = torch.sqrt(torch.sum(toe_f * toe_f, dim=-1))
    return f_ext, toe_force_norm, toe_fn, toe_vel


def forward_dynamics(params: RobotParams, gc: torch.Tensor, gv: torch.Tensor,
                     tau_joint: torch.Tensor, base_wrench: torch.Tensor, tp=None,
                     slip_vel: float = 0.1, solver: str = "unrolled",
                     f_ext_extra: torch.Tensor | None = None,
                     impulse_scale: float = 0.0):
    """qdd = M^-1 (tau - h + contact). base_wrench = [f_world(3); n_base(3)].

    f_ext_extra: optional (..., 13, 6) world-origin wrenches added per body.
    solver: "unrolled" (the clamped factorization of :mod:`..ops.linalg`) or
    "native" (an LU solve, the JAX package's ``jnp.linalg.solve``: the one
    the MPC model differentiates through)."""
    kin = fk(params, gc)
    f_ext, toe_force_norm, toe_fn, toe_vel = contact_wrenches(
        params, kin, gv, tp, slip_vel, impulse_scale)
    f_ext = torch.cat([f_ext[..., :1, :] + _base_wrench(kin, base_wrench)[..., None, :],
                       f_ext[..., 1:, :]], dim=-2)
    if f_ext_extra is not None:
        f_ext = f_ext + f_ext_extra

    h = bias_forces(params, kin, gv, f_ext)
    M = mass_matrix(params, kin)
    tau_j = tau_joint - JOINT_DAMPING * gv[..., 6:]
    tau = torch.cat([torch.zeros_like(tau_j[..., :6]), tau_j], dim=-1)
    if solver == "unrolled":
        qdd = linalg.solve_cholesky(linalg.cholesky_unrolled(M), (tau - h)[..., None])[..., 0]
    elif solver == "native":
        # like jnp.linalg.solve, no check of the factorization (no host sync)
        qdd = torch.linalg.solve_ex(M, tau - h, check_errors=False)[0]
    else:
        raise ValueError(f"forward_dynamics: unknown solver {solver!r}")
    diag = StepDiagnostics(toe_pos=kin.toe_pos, toe_vel=toe_vel, toe_force_norm=toe_force_norm,
                           toe_normal_force=toe_fn, torque=tau_joint)
    return qdd, diag


def _base_wrench(kin: Kinematics, base_wrench: torch.Tensor) -> torch.Tensor:
    """base_wrench = [f_world(3); n_base(3)] as a world-origin spatial force
    (..., 6) on the base."""
    p0 = kin.p[..., 0, :]
    f_b, n_b = base_wrench[..., :3].expand_as(p0), base_wrench[..., 3:]
    return torch.cat([n_b + torch.cross(p0, f_b, dim=-1), f_b], dim=-1)


def substep_hard(params: RobotParams, gc: torch.Tensor, gv: torch.Tensor,
                 tau_joint: torch.Tensor, base_wrench: torch.Tensor, tp, dt: float,
                 f_ext_extra: torch.Tensor | None = None, n_iter: int = 12,
                 lam0: torch.Tensor | None = None):
    """One physics substep with hard (impulse) toe contact.

    forward_dynamics + integrate, with the toe forces replaced by the
    velocity-level friction-cone impulse solve of :mod:`.hard_contact`; the
    base box keeps the compliant model. One Cholesky factor of M serves the
    free velocity and the Delassus operator. Returns (gc2, gv2,
    StepDiagnostics, lam): the diagnostics report the impulse-equivalent
    normal force lam_n / dt and the post-impulse toe velocities; ``lam``
    (..., 4, 3) warm-starts the next substep's solve."""
    params_b = broadcast_params(params, gv.shape[:-1])
    kin = fk(params, gc)
    v = body_velocities(kin, gv)
    corners = ct.box_corner_points(kin.R[..., 0, :, :], kin.p[..., 0, :])
    corner_vel = sp.point_velocity(v[..., 0:1, :], corners)
    box_f, _ = ct.point_contact_force(
        corners, corner_vel, 0.0, tp, _scalar(params_b.contact_stiffness) * 0.25,
        _scalar(params_b.contact_damping) * 0.25, _scalar(params_b.friction), 0.1, 0.0)
    base = torch.sum(sp.force_at_point(box_f, corners), dim=-2) + _base_wrench(kin, base_wrench)
    f_ext = torch.cat([base[..., None, :],
                       torch.zeros_like(base)[..., None, :].expand(
                           base.shape[:-1] + (NUM_BODIES - 1, 6))], dim=-2)
    if f_ext_extra is not None:
        f_ext = f_ext + f_ext_extra

    h = bias_forces(params, kin, gv, f_ext)
    M = mass_matrix(params, kin)
    tau_j = tau_joint - JOINT_DAMPING * gv[..., 6:]
    tau = torch.cat([torch.zeros_like(tau_j[..., :6]), tau_j], dim=-1)
    L = linalg.cholesky_unrolled(M)
    gv_free = gv + dt * linalg.solve_cholesky(L, (tau - h)[..., None])[..., 0]

    J = hc.toe_jacobians(kin)
    gap, basis = hc.contact_frames(tp, kin.toe_pos)
    sol = hc.solve_impulses(M, J, gv_free, gap, basis, params_b.friction, dt, n_iter, lam0=lam0,
                            chol=L, restitution=params_b.restitution,
                            res_threshold=params_b.res_threshold)
    gc2, gv2 = integrate(gc, gv, (sol.gv_plus - gv) / dt, dt)
    lam_norm = torch.linalg.vector_norm(sol.lam, dim=-1) / dt
    diag = StepDiagnostics(toe_pos=kin.toe_pos, toe_vel=sol.toe_vel_plus,
                           toe_force_norm=lam_norm, toe_normal_force=sol.fn, torque=tau_joint)
    return gc2, gv2, diag, sol.lam


def integrate(gc: torch.Tensor, gv: torch.Tensor, qdd: torch.Tensor, dt: float):
    """Semi-implicit Euler: v += dt*a, then q += dt*v_new."""
    gv_new = gv + dt * qdd
    pos = gc[..., :3] + dt * gv_new[..., :3]
    quat = quat_integrate(gc[..., 3:7], gv_new[..., 3:6], dt)
    q = gc[..., 7:] + dt * gv_new[..., 6:]
    return torch.cat([pos, quat, q], dim=-1), gv_new


def nonlinearities(params: RobotParams, gc: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """Coriolis + gravity vector (GetNonlinear parity, Environment.hpp:1396-1402)."""
    kin = fk(params, gc)
    return bias_forces(params, kin, gv, torch.zeros(gc.shape[:-1] + (NUM_BODIES, 6),
                                                    dtype=gc.dtype, device=gc.device))


def inverse_mass_matrix(params: RobotParams, gc: torch.Tensor) -> torch.Tensor:
    """M^-1 (GetInverseMassMatrix parity, Environment.hpp:1375-1391)."""
    return torch.linalg.inv(mass_matrix(params, fk(params, gc)))
