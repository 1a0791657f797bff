"""6D spatial-vector algebra in world-origin coordinates, batched over
leading dims.

Port of ``phys/spatial.py``. Motion vectors are [omega(3); v_O(3)] and force
vectors [n_O(3); f(3)], both referenced at the world origin, so the
rigid-body algorithms of :mod:`.dynamics` need no per-body transforms.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        zero, -z, y,
        z, zero, -x,
        -y, x, zero,
    ], dim=-1).reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, com_w: torch.Tensor,
                    inertia_w: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia at the world origin.

    mass: (...,), com_w: (..., 3) world com, inertia_w: (..., 3, 3) rotational
    inertia about the com in world axes. Momentum [L_O; p] = I [omega; v_O]."""
    cx = skew(com_w)
    m = mass[..., None, None]
    cxt = cx.transpose(-1, -2)
    top_left = inertia_w + m * (cx @ cxt)
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([top_left, m * cx], dim=-1)
    bot = torch.cat([m * cxt, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def cross_motion(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Spatial cross product of motion vectors: m1 x m2."""
    w1, v1 = m1[..., :3], m1[..., 3:]
    w2, v2 = m2[..., :3], m2[..., 3:]
    return torch.cat([
        torch.cross(w1, w2, dim=-1),
        torch.cross(w1, v2, dim=-1) + torch.cross(v1, w2, dim=-1),
    ], dim=-1)


def cross_force(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product motion x* force (momentum-derivative bias)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([
        torch.cross(w, n, dim=-1) + torch.cross(v, fl, dim=-1),
        torch.cross(w, fl, dim=-1),
    ], dim=-1)


def force_at_point(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Linear force f applied at world point p -> spatial force at the origin."""
    f, p = torch.broadcast_tensors(f, p)
    return torch.cat([torch.cross(p, f, dim=-1), f], dim=-1)


def point_velocity(v_spatial: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Velocity of the body-fixed point at world position p."""
    w, v0 = v_spatial[..., :3], v_spatial[..., 3:]
    w, p = torch.broadcast_tensors(w, p)
    return v0 + torch.cross(w, p, dim=-1)
