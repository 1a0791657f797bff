"""Batch-in-lanes ("structure of arrays") physics substep, plain PyTorch.

Port of ``ops/phys_lanes.py``: one semi-implicit Euler compliant-contact
substep as an unrolled scalar graph where every "scalar" is a (B,) tensor.
It keeps the JAX version's list-of-(B,)-tensors structure so the two read
line by line. This is the plain version of the CUDA kernel in
``ops/phys_cuda.py`` (``csrc/phys_substep.cu``): the CPU path, and the oracle
the kernel is held against on the card. On a GPU it issues ~20k tiny kernels
per call and is far too slow for a rollout.

Restrictions, as in the kernel: ground contact with a vertical normal (flat,
or a height lookup ``ground_fn``), no attack-sphere wrenches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl

GRAVITY_Z = -9.81

_PARENT = [int(p) for p in mdl.PARENT]
_JAXIS = [[float(a) for a in ax] for ax in mdl.JAXIS]
_SHANK = [int(s) for s in mdl.SHANK_BODY_IDX]
_ROTOR = [float(r) for r in mdl.ROTOR_INERTIA]
_CORNER_SIGNS = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
_BOX = [float(b) for b in mdl.BODY_BOX_HALF]

# joints active for body b (besides the 6 base dofs): the leg chain up to b
_BODY_JOINTS = [[] for _ in range(13)]
for _b in range(1, 13):
    _leg, _k = (_b - 1) // 3, (_b - 1) % 3
    _BODY_JOINTS[_b] = [3 * _leg + _j for _j in range(_k + 1)]


# --- tiny "scalar" (= (B,) tensor) algebra ------------------------------------

def _v3(x, y, z):
    return [x, y, z]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _mat3_vec(R, v):
    return [R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2] for i in range(3)]


def _mat3_mat3(A, B):
    return [[A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j]
             for j in range(3)] for i in range(3)]


def _quat_to_mat(w, x, y, z):
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def _axis_angle_mat(axis, ang):
    """Rodrigues for a STATIC unit axis (python floats) and (B,) angle."""
    c, s = torch.cos(ang), torch.sin(ang)
    ax, ay, az = axis
    C = 1.0 - c
    return [
        [c + ax * ax * C, ax * ay * C - az * s, ax * az * C + ay * s],
        [ay * ax * C + az * s, c + ay * ay * C, ay * az * C - ax * s],
        [az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C],
    ]


class LaneParams(NamedTuple):
    """RobotParams with the env axis last. Indexing reads like the JAX
    version's nested lists: ``mass[b]``, ``com[b][i]``, ``inertia[b][i][j]``
    and ``joint_origin[j][i]`` are (B,) tensors."""
    mass: torch.Tensor          # (13, B)
    com: torch.Tensor           # (13, 3, B)
    inertia: torch.Tensor       # (13, 3, 3, B)
    joint_origin: torch.Tensor  # (12, 3, B)
    friction: torch.Tensor      # (B,)
    kn: torch.Tensor            # (B,)
    dn: torch.Tensor            # (B,)


def params_to_lanes(p) -> LaneParams:
    """RobotParams with a leading env axis -> LaneParams."""
    if p.mass.dim() != 2:
        raise ValueError(f"params_to_lanes needs batched params, got mass {tuple(p.mass.shape)}")
    mv = lambda x: torch.movedim(x, 0, -1).contiguous()  # noqa: E731
    return LaneParams(mass=mv(p.mass), com=mv(p.com), inertia=mv(p.inertia),
                      joint_origin=mv(p.joint_origin),
                      friction=p.friction.contiguous(),
                      kn=p.contact_stiffness.contiguous(),
                      dn=p.contact_damping.contiguous())


class LaneKin(NamedTuple):
    p: list        # 13 x 3 x (B,) body origins (world)
    R: list        # 13 x 3 x 3
    com_w: list    # 13 x 3
    axis_w: list   # 12 x 3 world joint axes
    anchor: list   # 12 x 3 world joint anchors
    toe: list      # 4 x 3 toe centers


def fk_lanes(P: LaneParams, g: list) -> LaneKin:
    """g: list of 19 (B,) coords [pos3, quat wxyz, q12]."""
    R = [_quat_to_mat(g[3], g[4], g[5], g[6])]
    p = [_v3(g[0], g[1], g[2])]
    axis_w, anchor = [], []
    for j in range(12):
        b = j + 1
        par = _PARENT[b]
        Rp, pp = R[par], p[par]
        anc = [pp[i] + Rp[i][0] * P.joint_origin[j][0]
               + Rp[i][1] * P.joint_origin[j][1]
               + Rp[i][2] * P.joint_origin[j][2] for i in range(3)]
        Rj = _axis_angle_mat(_JAXIS[j], g[7 + j])
        R.append(_mat3_mat3(Rp, Rj))
        p.append(anc)
        axis_w.append(_mat3_vec(Rp, _JAXIS[j]))
        anchor.append(anc)
    com_w = [[p[b][i] + _dot3(R[b][i], P.com[b]) for i in range(3)]
             for b in range(13)]
    toe = [[p[s][i] + R[s][i][2] * mdl.TOE_OFFSET_Z for i in range(3)]
           for s in _SHANK]
    return LaneKin(p=p, R=R, com_w=com_w, axis_w=axis_w, anchor=anchor, toe=toe)


def _s_columns(kin: LaneKin, base_p):
    """Motion-subspace columns S[d] = [omega(3); v_O(3)], d in 0..17.

    Dofs 0-2 base linear, 3-5 base angular (columns [e_k; p_base x e_k]),
    6+j joint axes."""
    zero = base_p[0] * 0.0
    one = zero + 1.0
    cols = []
    for k in range(3):  # base linear
        w = [zero, zero, zero]
        v = [one if i == k else zero for i in range(3)]
        cols.append(w + v)
    e = np.eye(3)
    for k in range(3):  # base angular: [e_k; p x e_k]
        ek = [float(e[k][i]) for i in range(3)]
        pxe = _cross(base_p, ek)
        cols.append([one if i == k else zero for i in range(3)] + pxe)
    for j in range(12):
        a = kin.axis_w[j]
        cols.append(list(a) + _cross(kin.anchor[j], a))
    return cols


def _spatial_inertia(P: LaneParams, kin: LaneKin, b: int):
    """6x6 world-origin spatial inertia of body b as a nested list."""
    R = kin.R[b]
    Ib = P.inertia[b]
    # I_w = R Ib R^T
    RI = [[R[i][0] * Ib[0][j] + R[i][1] * Ib[1][j] + R[i][2] * Ib[2][j]
           for j in range(3)] for i in range(3)]
    Iw = [[RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2]
           for j in range(3)] for i in range(3)]
    m = P.mass[b]
    c = kin.com_w[b]
    # cx = skew(c); TL = Iw + m cx cx^T; TR = m cx; BL = m cx^T; BR = m I
    cx = [[c[0] * 0.0, -c[2], c[1]],
          [c[2], c[0] * 0.0, -c[0]],
          [-c[1], c[0], c[1] * 0.0]]
    cxcxT = [[cx[i][0] * cx[j][0] + cx[i][1] * cx[j][1] + cx[i][2] * cx[j][2]
              for j in range(3)] for i in range(3)]
    I6 = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            I6[i][j] = Iw[i][j] + m * cxcxT[i][j]
            I6[i][3 + j] = m * cx[i][j]
            I6[3 + i][j] = m * cx[j][i]
            I6[3 + i][3 + j] = m * (1.0 if i == j else 0.0)
    return I6


def _mv6(M, v):
    return [sum(M[i][k] * v[k] for k in range(6)) for i in range(6)]


def _dot6(a, b):
    return sum(a[k] * b[k] for k in range(6))


def _contact_point(P: LaneParams, pos, vel, radius, slip_vel, impulse_scale,
                   kn_scale=1.0, dn_scale=1.0, ground_h=None):
    """Penalty contact against the ground with a vertical normal
    (contact.point_contact_force specialized). ground_h: optional (B,)
    terrain height under the point; None is flat ground at z = 0."""
    z = pos[2] if ground_h is None else pos[2] - ground_h
    pen = torch.clamp_min(radius - z, 0.0)
    active = (pen > 0.0).to(pen.dtype)
    vn = vel[2]
    fn = torch.clamp_min(P.kn * kn_scale * pen - P.dn * dn_scale * vn, 0.0) * active
    vt = [vel[0], vel[1]]
    vt_norm = torch.sqrt(vt[0] * vt[0] + vt[1] * vt[1]
                         + slip_vel * slip_vel * 1e-4)
    if impulse_scale > 0.0:
        ft = torch.minimum(P.friction * fn, impulse_scale * vt_norm)
    else:
        ft = P.friction * fn * torch.tanh(vt_norm / slip_vel)
    inv = ft / vt_norm
    return [-inv * vt[0], -inv * vt[1], fn], fn


class LaneDiag(NamedTuple):
    toe: list              # 4 x 3 toe centers
    toe_vel: list          # 4 x 3
    toe_force_norm: list   # 4 x (B,)
    toe_normal_force: list  # 4 x (B,)


def substep_lanes(P: LaneParams, g: list, v: list, tau: list,
                  base_wrench: list, slip_vel: float, impulse_scale: float,
                  dt: float, ground_fn=None):
    """One semi-implicit Euler substep; g: 19 coords, v: 18 vels,
    tau: 12 joint torques, base_wrench: 6 ([f_world; n_world]).
    ground_fn: optional (x, y) -> terrain height over (B,) lane tensors, read
    under each toe and base corner (vertical normal); None is flat ground.
    Returns (g', v', LaneDiag)."""
    kin = fk_lanes(P, g)
    S = _s_columns(kin, kin.p[0])

    # body spatial velocities (ANC sparsity: base cols + own-leg joints)
    v_base6 = [sum(S[d][i] * v[d] for d in range(6)) for i in range(6)]
    v_body = [v_base6]
    for b in range(1, 13):
        vb = list(v_body[_PARENT[b]])
        j = _BODY_JOINTS[b][-1]
        for i in range(6):
            vb[i] = vb[i] + S[6 + j][i] * v[6 + j]
        v_body.append(vb)

    # --- contact forces -> world-origin spatial wrenches per body
    f_ext = [[g[0] * 0.0 for _ in range(6)] for _ in range(13)]
    diag_fn, diag_f, toe_vels = [], [], []
    for leg in range(4):
        b = _SHANK[leg]
        tp = kin.toe[leg]
        w, v0 = v_body[b][:3], v_body[b][3:]
        tv = [v0[i] + _cross(w, tp)[i] for i in range(3)]
        gh = None if ground_fn is None else ground_fn(tp[0], tp[1])
        f, fn = _contact_point(P, tp, tv, mdl.TOE_RADIUS, slip_vel, impulse_scale,
                               ground_h=gh)
        nxf = _cross(tp, f)
        for i in range(3):
            f_ext[b][i] = f_ext[b][i] + nxf[i]
            f_ext[b][3 + i] = f_ext[b][3 + i] + f[i]
        diag_fn.append(fn)
        diag_f.append(torch.sqrt(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]))
        toe_vels.append(tv)

    R0, p0 = kin.R[0], kin.p[0]
    w0, v00 = v_body[0][:3], v_body[0][3:]
    for sx, sy, sz in _CORNER_SIGNS:
        local = [sx * _BOX[0], sy * _BOX[1], sz * _BOX[2]]
        cp = [p0[i] + _dot3(R0[i], local) for i in range(3)]
        cv = [v00[i] + _cross(w0, cp)[i] for i in range(3)]
        gh = None if ground_fn is None else ground_fn(cp[0], cp[1])
        f, _ = _contact_point(P, cp, cv, 0.0, slip_vel, impulse_scale,
                              kn_scale=0.25, dn_scale=0.25, ground_h=gh)
        nxf = _cross(cp, f)
        for i in range(3):
            f_ext[0][i] = f_ext[0][i] + nxf[i]
            f_ext[0][3 + i] = f_ext[0][3 + i] + f[i]

    # base wrench (force_attack convention: [f_world(3); n_base(3)])
    fb = base_wrench[:3]
    nb = base_wrench[3:]
    pxf = _cross(p0, fb)
    for i in range(3):
        f_ext[0][i] = f_ext[0][i] + nb[i] + pxf[i]
        f_ext[0][3 + i] = f_ext[0][3 + i] + fb[i]

    # --- spatial inertias + bias accelerations (RNEA with qdd = 0)
    I6 = [_spatial_inertia(P, kin, b) for b in range(13)]
    a = [[g[0] * 0.0] * 3 + list(_cross(v[:3], v[3:6]))]
    for b in range(1, 13):
        par = _PARENT[b]
        j = _BODY_JOINTS[b][-1]
        Sj = [S[6 + j][i] for i in range(6)]
        vp = v_body[par]
        # cross_motion(vp, Sj) * qd_j
        wxw = _cross(vp[:3], Sj[:3])
        wxv = _cross(vp[:3], Sj[3:])
        vxw = _cross(vp[3:], Sj[:3])
        ab = list(a[par])
        qd = v[6 + j]
        for i in range(3):
            ab[i] = ab[i] + wxw[i] * qd
            ab[3 + i] = ab[3 + i] + (wxv[i] + vxw[i]) * qd
        a.append(ab)

    # f_net_b = I a + v x* (I v) - f_grav - f_ext ; tau_bias[d] = sum_b S_d . f_net_b
    f_net = []
    for b in range(13):
        Iv = _mv6(I6[b], v_body[b])
        Ia = _mv6(I6[b], a[b])
        w, vl = v_body[b][:3], v_body[b][3:]
        n, fl = Iv[:3], Iv[3:]
        cf = _cross(w, n)
        cf2 = _cross(vl, fl)
        cff = _cross(w, fl)
        grav_z = P.mass[b] * GRAVITY_Z
        grav = [0.0, 0.0, grav_z]
        gn = _cross(kin.com_w[b], grav)
        fb6 = [Ia[0] + cf[0] + cf2[0] - gn[0] - f_ext[b][0],
               Ia[1] + cf[1] + cf2[1] - gn[1] - f_ext[b][1],
               Ia[2] + cf[2] + cf2[2] - gn[2] - f_ext[b][2],
               Ia[3] + cff[0] - grav[0] - f_ext[b][3],
               Ia[4] + cff[1] - grav[1] - f_ext[b][4],
               Ia[5] + cff[2] - grav[2] - f_ext[b][5]]
        f_net.append(fb6)

    h = []
    for d in range(18):
        s = g[0] * 0.0
        if d < 6:
            bodies = range(13)
        else:
            j = d - 6
            leg, k = j // 3, j % 3
            bodies = [1 + 3 * leg + kk for kk in range(k, 3)]
        for b in bodies:
            s = s + _dot6(S[d], f_net[b])
        h.append(s)

    # --- mass matrix (CRBA with path sparsity) + rotor inertias
    M = [[g[0] * 0.0 for _ in range(18)] for _ in range(18)]
    for b in range(13):
        dofs = list(range(6)) + [6 + j for j in _BODY_JOINTS[b]]
        F = {e: _mv6(I6[b], S[e]) for e in dofs}
        for di in range(len(dofs)):
            d = dofs[di]
            for e in dofs[di:]:
                M[d][e] = M[d][e] + _dot6(S[d], F[e])
    for d in range(18):
        for e in range(d):
            M[d][e] = M[e][d]
    for j in range(12):
        M[6 + j][6 + j] = M[6 + j][6 + j] + _ROTOR[j]

    # --- rhs and unrolled Cholesky solve
    rhs = [-h[d] for d in range(6)]
    for j in range(12):
        rhs.append(tau[j] - mdl.JOINT_DAMPING * v[6 + j] - h[6 + j])

    qdd = _solve_spd_lists(M, rhs)

    # --- semi-implicit Euler (exact exp-map quaternion update, sinc guard)
    v_new = [v[d] + dt * qdd[d] for d in range(18)]
    pos = [g[i] + dt * v_new[i] for i in range(3)]
    qw, qx, qy, qz = g[3], g[4], g[5], g[6]
    ox, oy, oz = v_new[3], v_new[4], v_new[5]
    angle = torch.sqrt(ox * ox + oy * oy + oz * oz)
    half = 0.5 * angle * dt
    k = torch.where(angle > 1e-9, torch.sin(half) / torch.clamp_min(angle, 1e-12),
                    torch.full_like(angle, 0.5 * dt))
    dw, dx, dy, dz = torch.cos(half), k * ox, k * oy, k * oz
    # Hamilton product dq * q (wxyz)
    nw = dw * qw - dx * qx - dy * qy - dz * qz
    nx = dw * qx + dx * qw + dy * qz - dz * qy
    ny = dw * qy - dx * qz + dy * qw + dz * qx
    nz = dw * qz + dx * qy - dy * qx + dz * qw
    inv = 1.0 / torch.sqrt(nw * nw + nx * nx + ny * ny + nz * nz)
    quat = [nw * inv, nx * inv, ny * inv, nz * inv]
    q = [g[7 + j] + dt * v_new[6 + j] for j in range(12)]

    diag = LaneDiag(toe=kin.toe, toe_vel=toe_vels,
                    toe_force_norm=diag_f, toe_normal_force=diag_fn)
    return pos + quat + q, v_new, diag


def _solve_spd_lists(M, b):
    """x = M^-1 b, M/b nested lists of (B,) scalars (unrolled Cholesky)."""
    n = len(b)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


# --- array-in/array-out wrapper ------------------------------------------------

def substep(P: LaneParams, gcT: torch.Tensor, gvT: torch.Tensor,
            tauT: torch.Tensor, base_wrenchT: torch.Tensor,
            slip_vel: float, impulse_scale: float, dt: float, ground_fn=None):
    """(19,B),(18,B),(12,B),(6,B) -> (gcT' (19,B), gvT' (18,B), toe (4,3,B),
    toe_vel (4,3,B), force norm (4,B), normal force (4,B)); ``ground_fn`` as
    in :func:`substep_lanes`."""
    g = [gcT[i] for i in range(19)]
    v = [gvT[i] for i in range(18)]
    tau = [tauT[i] for i in range(12)]
    bw = [base_wrenchT[i] for i in range(6)]
    g2, v2, diag = substep_lanes(P, g, v, tau, bw, slip_vel, impulse_scale, dt, ground_fn)
    toe = torch.stack([torch.stack(t) for t in diag.toe])          # (4,3,B)
    toe_vel = torch.stack([torch.stack(t) for t in diag.toe_vel])  # (4,3,B)
    fnorm = torch.stack(diag.toe_force_norm)                       # (4,B)
    fnormal = torch.stack(diag.toe_normal_force)                   # (4,B)
    return (torch.stack(g2), torch.stack(v2), toe, toe_vel, fnorm, fnormal)
