"""Quaternion / rotation helpers (wxyz, scalar first), batched over leading
dims. Port of ``utils/rotation.py``: the quaternion algebra the environment,
the rigid-body dynamics and the whole-body MPC cost use, and the Euler
conversions of the reference's ``Rotation.py`` that the ensemble-entropy
experiment (``analysis/robustness``) uses."""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion (..., 4) -> (..., 3, 3) rotation matrix (body->world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (body->world if q is body orientation)."""
    return torch.einsum("...ij,...j->...i", quat_to_matrix(q), v)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation by world-frame angular velocity over dt (exp map).

    The rate's norm is ``sqrt(sum(w * w))`` as in the JAX package, so its
    forward derivative at a zero rate is the same (not a number) there and
    here."""
    angle = torch.sqrt(torch.sum(omega_world * omega_world, dim=-1, keepdim=True))
    half = 0.5 * angle * dt
    k = torch.where(angle > 1e-9, torch.sin(half) / torch.clamp_min(angle, 1e-12), 0.5 * dt)
    dq = torch.cat([torch.cos(half), k * omega_world], dim=-1)
    return quat_normalize(quat_mul(dq, q))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


# --- parity with IRRL/script/utils/Rotation.py ------------------------------

def qua2euler(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> (roll, pitch, yaw), ZYX convention."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler2qua(e: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) -> wxyz quaternion, ZYX convention."""
    r, p, y = e[..., 0] * 0.5, e[..., 1] * 0.5, e[..., 2] * 0.5
    cr, sr, cp, sp = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)
