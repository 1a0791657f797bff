"""Structure-exploiting linearization for the whole-body MPC.

Port of ``mpc/linearize.py``. The iLQR needs per-knot Jacobians A = dx'/dx,
B = dx'/du of the control-step dynamics. Central differences cost 2 (n+m) = 98
physics evaluations a knot; this gets them for about one, from the structure

    qdd = M(q)^-1 (tau(q, v, u) + J(q)^T f_c(q, v) - h(q, v)):

the stiff, cheap terms (PD -> torque clamp, the toes' penalty contact) are
differentiated exactly through a surrogate that re-evaluates FK, the joint
projection and the contact law; the smooth, expensive operators (M^-1 and the
Coriolis/gravity bias h_0) are computed once a knot with the full physics and
held constant (:class:`FrozenOps`). Rollouts and the line search still use the
exact dynamics, so only the derivative is approximate.

The frozen operators are computed batched, outside the derivative transform,
and passed in as constants, as the JAX package freezes them under ``jacfwd``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs.blackpanther import torque_clamp
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import contact as ct
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import spatial as sp
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import (
    JOINT_DAMPING, NUM_BODIES, TOE_RADIUS,
)


class FrozenOps(NamedTuple):
    """Expensive operators evaluated once a knot, constant under the derivative."""
    Minv: torch.Tensor   # (..., 18, 18)
    h0: torch.Tensor     # (..., 18) Coriolis + gravity bias (no contact)


def make_frozen_linearizer(cfg: EnvConfig, mpc_cfg, params: mdl.RobotParams, terrain=None):
    """Per-knot (A, B) of the control-step dynamics via the frozen-operator
    surrogate: ``linearize(X (..., n), U (..., m)) -> (A (..., n, n),
    B (..., n, m))``, whose leading dims broadcast against the params' (none
    for one robot). Serves ``ilqr.solve``'s ``linearize_fn`` and
    ``ilqr.solve_batch``'s ``linearize_b``.

    Matches ``trot.make_dynamics``: ``model_substeps`` semi-implicit Euler
    substeps of PD (+ clamp) -> forward dynamics a control step, no base
    wrench. ``terrain``: None for flat ground, or a
    :class:`~..phys.terrain.SampledTerrain` for the toes' contact (the
    bilinear height is piecewise linear under the derivative)."""
    sub_dt = cfg.control_dt / mpc_cfg.model_substeps
    device = params.mass.device
    action_mean = dev_mod.tensor(mdl.stand_gc(cfg.abad)[7:], device)
    gains = dev_mod.tensor([cfg.abad_ratio, 1.0, 1.0] * 4, device)
    kp, kd = cfg.stiffness * gains, cfg.damping * gains

    def compute_frozen(X):
        gc, gv = X[..., :19], X[..., 19:]
        kin = dyn.fk(params, gc)
        Minv = linalg.inv_spd(dyn.mass_matrix(params, kin))
        h0 = dyn.bias_forces(params, kin, gv, torch.zeros(
            gc.shape[:-1] + (NUM_BODIES, 6), dtype=gc.dtype, device=gc.device))
        return FrozenOps(Minv=Minv, h0=h0)

    def contact_proj(kin, gv):
        """Generalized contact force sum_b S^T f_b, toes only (the base box
        only matters mid-fall)."""
        p = dyn.broadcast_params(params, gv.shape[:-1])
        v = dyn.body_velocities(kin, gv)
        toe_vel = sp.point_velocity(v[..., dyn.SHANKS, :], kin.toe_pos)
        toe_f, _ = ct.point_contact_force(
            kin.toe_pos, toe_vel, TOE_RADIUS, terrain, p.contact_stiffness[..., None],
            p.contact_damping[..., None], p.friction[..., None], cfg.contact_slip_vel, 0.0)
        f_toe = sp.force_at_point(toe_f, kin.toe_pos)                     # (...,4,6)
        anc = dyn._consts(gv.device).anc[dyn.SHANKS]                      # (4,18)
        return torch.einsum("...pd,...bp,bd->...d", kin.S, f_toe, anc)

    def substep_sur(gc, gv, u, frozen):
        ptarget = u + action_mean
        tau_j = kp * (ptarget - gc[..., 7:]) - kd * gv[..., 6:]
        tau_j = torque_clamp(cfg, tau_j, gv[..., 6:])
        tau_j = tau_j - JOINT_DAMPING * gv[..., 6:]
        tau = torch.cat([torch.zeros_like(tau_j[..., :6]), tau_j], dim=-1)
        kin = dyn.fk(params, gc)   # cheap, differentiated exactly
        rhs = tau + contact_proj(kin, gv) - frozen.h0
        qdd = (frozen.Minv @ rhs[..., None])[..., 0]
        return dyn.integrate(gc, gv, qdd, sub_dt)

    def step_sur(x, u, frozen):
        gc, gv = x[..., :19], x[..., 19:]
        for _ in range(mpc_cfg.model_substeps):
            gc, gv = substep_sur(gc, gv, u, frozen)
        return torch.cat([gc, gv], dim=-1)

    def linearize(X, U):
        frozen = compute_frozen(X)
        return ilqr.jacobian(lambda x, u: step_sur(x, u, frozen), X, U)

    return linearize
