r"""Hard (impulse-level) toe contact, batched over leading dims.

Port of ``phys/hard_contact.py``: after the smooth-force velocity update
(gravity, PD torques, base-box contact: everything except the toe forces),
the 4 toe contacts' local impulses ``lam`` solve the friction-cone
complementarity problem

    v+ = v_free + M^-1 J^T lam
    0 <= lam_n  \perp  (v+_n - v_des) >= 0,      v_des = ERP push-out
    ||lam_t|| <= mu * lam_n   at minimum dissipation (v+_t -> 0 in stick)

by fixed-iteration projected Gauss-Seidel over the contacts. A sweep visits
the contacts in order, and each reads the impulses of the contacts already
updated in the same sweep (JAX's ``lam.at[i].set`` inside its unrolled loop);
the envs of a batch are independent and run side by side. The toe Jacobian
is analytic: body b's motion subspace masked by ancestry, a point's linear
rows minus ``skew(p)`` times its angular rows.

This is plain PyTorch because the JAX package computes it outside any Pallas
kernel (it runs only on the per-env ``envs.blackpanther.step``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import contact as ct
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import spatial as sp
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import (
    ANC_MASK, SHANK_BODY_IDX, TOE_RADIUS,
)

# Baumgarte stabilization: push-out velocity v_des = ERP * pen / dt, capped.
ERP = 0.2
SLOP = 1e-3          # [m] penetration allowance before push-out kicks in
V_PUSH_MAX = 0.5     # [m/s] push-out cap (avoids explosive depenetration)
N_CONTACTS = 4


class ContactSolution(NamedTuple):
    gv_plus: torch.Tensor       # (..., 18) post-impulse generalized velocity
    lam: torch.Tensor           # (..., 4, 3) local impulses [n, t1, t2] (N s)
    fn: torch.Tensor            # (..., 4) equivalent normal force lam_n / dt [N]
    toe_vel_plus: torch.Tensor  # (..., 4, 3) post-impulse world toe velocities


@functools.lru_cache(maxsize=8)
def _shank_anc(device: torch.device) -> torch.Tensor:
    return dev_mod.tensor(ANC_MASK[SHANK_BODY_IDX], device)     # (4, 18)


def toe_jacobians(kin) -> torch.Tensor:
    """(..., 4, 3, 18) world-frame point Jacobians of the toe centers:
    v_toe = J gv."""
    phi = kin.S[..., None, :, :] * _shank_anc(kin.S.device)[:, None, :]   # (...,4,6,18)
    return phi[..., 3:, :] - sp.skew(kin.toe_pos) @ phi[..., :3, :]


def contact_frames(tp, toe_pos: torch.Tensor):
    """Per-toe gap (..., 4) and orthonormal contact basis (..., 4, 3, 3),
    columns [n, t1, t2]. gap < 0 marks an active contact. ``tp``: None for
    flat ground, or a terrain of :mod:`.terrain` with the state's
    batch dims (the terrain's own normal)."""
    if tp is None:
        ground = torch.zeros_like(toe_pos[..., 0])
        n = torch.zeros_like(toe_pos)
        n[..., 2] = 1.0
    else:
        ground = ct._height(tp, toe_pos[..., 0], toe_pos[..., 1])
        n = ct._normal(tp, toe_pos[..., 0], toe_pos[..., 1])
    gap = (toe_pos[..., 2] - ground) * n[..., 2] - TOE_RADIUS
    # tangent basis: project world-x out of n; world-y where n is near world-x
    ex, ey = torch.zeros_like(n), torch.zeros_like(n)
    ex[..., 0] = 1.0
    ey[..., 1] = 1.0
    seed = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    t1 = seed - n * torch.sum(n * seed, dim=-1, keepdim=True)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-6)
    t2 = torch.cross(n, t1, dim=-1)
    return gap, torch.stack([n, t1, t2], dim=-1)


def solve_impulses(M: torch.Tensor, J: torch.Tensor, gv_free: torch.Tensor,
                   gap: torch.Tensor, basis: torch.Tensor, mu, dt: float, n_iter: int = 12,
                   lam0: torch.Tensor | None = None, chol: torch.Tensor | None = None,
                   restitution=0.0, res_threshold=0.0) -> ContactSolution:
    """Projected Gauss-Seidel over the 4 toe contacts of every env.

    M (..., 18, 18), J (..., 4, 3, 18), gv_free (..., 18), gap (..., 4),
    basis (..., 4, 3, 3); ``mu``, ``restitution`` and ``res_threshold`` are
    per-env scalars (a number or a (...) tensor). ``lam0`` warm-starts the
    impulses (the previous substep's, dropped where a contact broke);
    ``chol`` is the lower factor of M if the caller has it. A contact whose
    approach speed exceeds ``res_threshold`` targets the outgoing normal
    velocity ``restitution * |vn-|`` (Newton restitution)."""
    batch = gv_free.shape[:-1]
    as_env = lambda x: torch.as_tensor(x, dtype=gv_free.dtype, device=gv_free.device)  # noqa: E731
    mu, restitution, res_threshold = as_env(mu), as_env(restitution), as_env(res_threshold)
    # local-frame Jacobians: rows give the contact-point velocity in [n, t1, t2]
    Jl = torch.einsum("...cki,...ckd->...cid", basis, J).reshape(batch + (12, 18))
    if chol is None:
        chol = linalg.cholesky_unrolled(M)
    W = linalg.solve_cholesky(chol, Jl.transpose(-1, -2))          # M^-1 J^T (..., 18, 12)
    G = Jl @ W                                                      # (..., 12, 12) Delassus
    Gc = G.unflatten(-2, (N_CONTACTS, 3))                           # per-contact rows
    v0 = (Jl @ gv_free[..., None])[..., 0].unflatten(-1, (N_CONTACTS, 3))
    active = gap < 0.0
    v_des = torch.clamp_max(ERP * torch.clamp_min(-gap - SLOP, 0.0) / dt, V_PUSH_MAX)
    vn_approach = torch.clamp_min(-v0[..., 0], 0.0)
    v_des = torch.maximum(v_des, restitution[..., None] * torch.where(
        vn_approach > res_threshold[..., None], vn_approach, torch.zeros_like(vn_approach)))
    Gd = torch.diagonal(G, dim1=-2, dim2=-1).unflatten(-1, (N_CONTACTS, 3))

    lam = torch.zeros(batch + (N_CONTACTS, 3), dtype=gv_free.dtype,
                      device=gv_free.device) if lam0 is None else lam0
    lam = lam * active[..., None]           # drop impulses of broken contacts
    lams = list(lam.unbind(-2))
    mask = active.to(gv_free.dtype)
    for _ in range(n_iter):
        for i in range(N_CONTACTS):         # the sweep, in contact order
            v = v0[..., i, :] + (Gc[..., i, :, :] @ torch.cat(lams, dim=-1)[..., None])[..., 0]
            ln = torch.clamp_min(lams[i][..., 0] - (v[..., 0] - v_des[..., i]) / Gd[..., i, 0],
                                 0.0)
            lt = lams[i][..., 1:] - v[..., 1:] / Gd[..., i, 1:]
            lt_norm = torch.clamp_min(torch.linalg.vector_norm(lt, dim=-1), 1e-12)
            lt = lt * torch.clamp_max(mu * ln / lt_norm, 1.0)[..., None]
            lams[i] = torch.cat([ln[..., None], lt], dim=-1) * mask[..., i, None]
    lam = torch.stack(lams, dim=-2)
    gv_plus = gv_free + (W @ lam.flatten(-2)[..., None])[..., 0]
    toe_vel_plus = torch.einsum("...cid,...d->...ci", J, gv_plus)
    return ContactSolution(gv_plus=gv_plus, lam=lam, fn=lam[..., 0] / dt,
                           toe_vel_plus=toe_vel_plus)
