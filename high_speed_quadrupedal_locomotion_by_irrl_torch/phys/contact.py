"""Compliant (penalty) contact for the BlackPanther collision set, batched
over leading dims.

Port of ``phys/contact.py``: a spring-damper normal force with smooth
Coulomb friction at 4 toe spheres (r = 0.0275) and the 8 corners of the
base's 0.3 x 0.2 x 0.1 box. The ground is flat (``tp=None``: height 0,
normal (0, 0, 1)) or a terrain of :mod:`.terrain` (a
:class:`~.terrain.SampledTerrain` or an analytic
:class:`~.terrain.TerrainParams` whose fields carry the state's batch dims),
with the JAX package's height, central-difference normal and projected gap.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as _terrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import BODY_BOX_HALF

_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                    dtype=np.float64) * BODY_BOX_HALF


@functools.lru_cache(maxsize=8)
def _corners(device: torch.device) -> torch.Tensor:
    return dev_mod.tensor(_CORNERS, device)


def _height(tp, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Terrain under points (..., k) of envs whose fields are (...)."""
    f = lambda t: t[..., None]  # noqa: E731  the point axis
    if isinstance(tp, _terrain.TerrainParams):
        return _terrain.analytic_height(f(tp.seed), f(tp.z_scale), x, y)
    return _terrain._bilinear(_terrain.grid(x.device), f(tp.offset[..., 0]),
                              f(tp.offset[..., 1]), f(tp.cell), f(tp.z_scale), x, y)


def _normal(tp, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    eps = 1e-3
    dhdx = (_height(tp, x + eps, y) - _height(tp, x - eps, y)) / (2 * eps)
    dhdy = (_height(tp, x, y + eps) - _height(tp, x, y - eps)) / (2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(x)], dim=-1)
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))


def point_contact_force(pos, vel, radius, tp, stiffness, damping, friction,
                        slip_vel, impulse_scale: float = 0.0):
    """Contact force at sphere-like points against the ground.

    pos, vel: (..., k, 3) world position/velocity of the point centers;
    stiffness, damping, friction broadcast against (..., k). Returns
    (force_world (..., k, 3), normal force magnitude (..., k)). Friction:
    tanh-regularized Coulomb (impulse_scale 0), or the tangential force that
    stops the point within a substep capped at the Coulomb limit
    (impulse_scale = m_eff / dt > 0)."""
    if tp is None:
        gap = pos[..., 2] - radius
        vn = vel[..., 2]
        vt = torch.cat([vel[..., :2], torch.zeros_like(vel[..., 2:])], dim=-1)
        n = None
    else:
        ground = _height(tp, pos[..., 0], pos[..., 1])
        n = _normal(tp, pos[..., 0], pos[..., 1])
        # penetration along the normal (flat-ground exact; terrain approximated
        # by the vertical gap projected on the normal)
        gap = (pos[..., 2] - ground) * n[..., 2] - radius
        vn = torch.sum(vel * n, dim=-1)
        vt = vel - vn[..., None] * n
    pen = torch.clamp_min(-gap, 0.0)
    active = (pen > 0.0).to(pen.dtype)
    fn = torch.clamp_min(stiffness * pen - damping * vn, 0.0) * active
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1) + slip_vel * slip_vel * 1e-4)
    if impulse_scale > 0.0:
        ft_mag = torch.minimum(friction * fn, impulse_scale * vt_norm)
    else:
        ft_mag = friction * fn * torch.tanh(vt_norm / slip_vel)
    tangential = ft_mag[..., None] * vt / vt_norm[..., None]
    if n is None:
        normal = torch.cat([torch.zeros_like(vt[..., :2]), fn[..., None]], dim=-1)
    else:
        normal = fn[..., None] * n
    return normal - tangential, fn


def box_corner_points(base_R: torch.Tensor, base_p: torch.Tensor) -> torch.Tensor:
    """World positions (..., 8, 3) of the base-box corners; base_R (..., 3, 3),
    base_p (..., 3)."""
    return base_p[..., None, :] + torch.einsum("...ij,cj->...ci", base_R,
                                               _corners(base_R.device))
