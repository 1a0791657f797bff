"""Batched whole-body trot-MPC: iLQR over the BlackPanther dynamics tracking
the Bezier gait reference.

Port of ``mpc/trot.py``, with a leading problem axis on every tensor
(:class:`TrotProblem` fields are (B, ...)). The MPC's internal model is the
training env's PD -> torque clamp -> contact physics with ``model_substeps``
substeps a control step (default 2 x 1 ms). Two solvers:

* :func:`solve` / :func:`batched_solve`: ``ilqr.solve`` over the dense
  per-env physics of :mod:`..phys.dynamics` (``make_dynamics``), plain
  PyTorch, with per-problem robots allowed;
* :func:`solve_batch_lanes`: ``ilqr.solve_batch`` over the batch-in-lanes
  physics (``make_dynamics_batch``), whose substep is the hand-written kernel
  of ``ops/phys_cuda.py`` on the card: rollouts, line searches and the
  finite-difference sweep are each one launch a substep, K = problems,
  problems x step sizes, or problems x knots x 2 (37 + 12) lanes wide.

Entry points run on the device of the problem's tensors; make them with
``device="cpu"`` to run on the CPU (the physics then takes its plain version).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs.blackpanther import torque_clamp
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import cost as mcost
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import linearize
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 50
    n_iter: int = 8
    model_substeps: int = 2
    # knots linearized per block: a memory bound (the JAX package's 1 keeps
    # large batched solves inside the TPU's HBM)
    linearize_chunk: int = 1
    n_alphas: int = 8       # parallel line-search step sizes
    relin_every: int = 1    # Jacobian reuse interval (ilqr.solve notes)
    fd_eps: float = 1e-3    # central-FD step of the lanes solver; 0 = forward-mode AD
    linearizer: str = "fd"  # "fd" (central differences through the lanes dynamics;
                            # forward-mode AD in the dense solver) or "frozen" (the
                            # frozen-operator surrogate of mpc/linearize.py)
    weights: mcost.CostWeights = dataclasses.field(default_factory=mcost.imitation_weights)


class TrotProblem(NamedTuple):
    x0: torch.Tensor              # (B, 37) [gc; gv]
    command: torch.Tensor         # (B, 3)
    t0: torch.Tensor              # (B,) gait clock at the first knot
    joint_refs: torch.Tensor      # (B, T, 12)
    joint_dot_refs: torch.Tensor  # (B, T, 12)
    joint_ref_T: torch.Tensor     # (B, 12) reference at the terminal knot T


@functools.lru_cache(maxsize=16)
def _model_consts(cfg: EnvConfig, device: torch.device):
    """(action mean (12,), kp (12,), kd (12,)) of the MPC model's PD law."""
    gains = dev_mod.tensor([cfg.abad_ratio, 1.0, 1.0] * 4, device)
    return (dev_mod.tensor(mdl.stand_gc(cfg.abad)[7:], device), cfg.stiffness * gains,
            cfg.damping * gains)


def make_problem(cfg: EnvConfig, gc: torch.Tensor, gv: torch.Tensor,
                 command: torch.Tensor, t0: torch.Tensor, horizon: int,
                 xy_shift: torch.Tensor | None = None) -> TrotProblem:
    """B problems from gc (B, 19), gv (B, 18), command (B, 3), t0 (B,).
    xy_shift: optional (B, 2) Raibert foothold correction, applied as a
    Bezier-endpoint shift weighted per leg by ``gait.raibert_weight``."""
    dev = gc.device
    ts = t0[:, None] + torch.arange(horizon + 1, dtype=dev_mod.DTYPE, device=dev) * cfg.control_dt
    cmd = command[:, None, :].expand(ts.shape + (3,))
    shift = None
    if xy_shift is not None:
        shift = xy_shift[:, None, None, :] * gait.raibert_weight(cfg, ts)[..., None]
    refs = gait.gait_reference(cfg, cmd, ts, shift).joint_ref          # (B, T+1, 12)
    jd = (refs[:, 1:] - refs[:, :-1]) / cfg.control_dt
    return TrotProblem(x0=torch.cat([gc, gv], dim=-1), command=command, t0=t0,
                       joint_refs=refs[:, :-1], joint_dot_refs=jd, joint_ref_T=refs[:, -1])


def make_dynamics(cfg: EnvConfig, mpc_cfg: MPCConfig, params: mdl.RobotParams, terrain=None):
    """Control-step dynamics ``step(x (..., 37), u (..., 12), t) -> (..., 37)``
    of the MPC model on the dense physics; ``params`` unbatched or with
    leading dims that broadcast against x's. ``terrain``: None (flat) or a
    :class:`~..phys.terrain.SampledTerrain`."""
    sub_dt = cfg.control_dt / mpc_cfg.model_substeps
    action_mean, kp, kd = _model_consts(cfg, params.mass.device)

    def step(x, u, t):
        del t
        ptarget = u + action_mean
        gc, gv = x[..., :19], x[..., 19:]
        zero_wrench = torch.zeros_like(x[..., :6])
        for _ in range(mpc_cfg.model_substeps):
            tau = kp * (ptarget - gc[..., 7:]) - kd * gv[..., 6:]
            tau = torque_clamp(cfg, tau, gv[..., 6:])
            # "native": torch.linalg.solve, as the JAX package's jnp.linalg.solve
            qdd, _ = dyn.forward_dynamics(params, gc, gv, tau, zero_wrench, terrain,
                                          cfg.contact_slip_vel, solver="native")
            gc, gv = dyn.integrate(gc, gv, qdd, sub_dt)
        return torch.cat([gc, gv], dim=-1)

    return step


def make_linearize_fn(cfg: EnvConfig, mpc_cfg: MPCConfig, params: mdl.RobotParams,
                      terrain=None):
    """The MPCConfig-selected Jacobian provider (None = forward-mode AD)."""
    if mpc_cfg.linearizer != "frozen":
        return None
    return linearize.make_frozen_linearizer(cfg, mpc_cfg, params, terrain)


def _u_init(cfg: EnvConfig, probs: TrotProblem) -> torch.Tensor:
    """Warm start: track the joint reference directly (u = q_ref - stand pose)."""
    return probs.joint_refs - _model_consts(cfg, probs.x0.device)[0]


def cost_fns(cfg: EnvConfig, mpc_cfg: MPCConfig, prob: TrotProblem):
    """(stage cost, terminal cost) of ``prob`` in ``ilqr.solve``'s form."""
    w = mpc_cfg.weights
    command = prob.command[:, None, :]

    def cost_fn(x, u, t):
        return mcost.stage_cost(cfg, w, x, u, prob.joint_refs[:, t], prob.joint_dot_refs[:, t],
                                command)

    def term_fn(x):
        return mcost.terminal_cost(cfg, w, x, prob.joint_ref_T, prob.command)

    return cost_fn, term_fn


def solve(cfg: EnvConfig, mpc_cfg: MPCConfig, params: mdl.RobotParams,
          prob: TrotProblem) -> ilqr.ILQRResult:
    """The B problems of ``prob`` on the dense physics; ``params`` one robot
    for all, or (B, ...) per problem."""
    dynamics = make_dynamics(cfg, mpc_cfg, params)
    return ilqr.solve(dynamics, *cost_fns(cfg, mpc_cfg, prob), prob.x0, _u_init(cfg, prob),
                      n_iter=mpc_cfg.n_iter, linearize_chunk=mpc_cfg.linearize_chunk,
                      n_alphas=mpc_cfg.n_alphas, relin_every=mpc_cfg.relin_every,
                      linearize_fn=make_linearize_fn(cfg, mpc_cfg, params))


def batched_solve(cfg: EnvConfig, mpc_cfg: MPCConfig, params_batch: mdl.RobotParams,
                  probs: TrotProblem) -> ilqr.ILQRResult:
    """The JAX package's ``vmap(solve)``: :func:`solve` already carries the
    problem axis; ``params_batch`` may be per problem (domain-randomized)."""
    return solve(cfg, mpc_cfg, params_batch, probs)


def make_dynamics_batch(cfg: EnvConfig, mpc_cfg: MPCConfig, params: mdl.RobotParams):
    """Control-step dynamics ``step(xs (K, 37), us (K, 12)) -> (K, 37)`` on
    the batch-in-lanes physics. Each substep is the PD law and the torque
    clamp in PyTorch, then ONE launch of the substep kernel
    (``ops/phys_cuda.substep``: slip ``cfg.contact_slip_vel``, impulse scale
    0, zero base wrench); on CPU tensors the kernel's plain version.
    ``params`` is the nominal (unbatched) robot of every lane."""
    sub_dt = cfg.control_dt / mpc_cfg.model_substeps
    action_mean, kp, kd = _model_consts(cfg, params.mass.device)
    kp, kd = kp[:, None], kd[:, None]
    lane_params: dict[int, lanes.LaneParams] = {}

    def step(xs, us):
        K = xs.shape[0]
        if K not in lane_params:
            lane_params[K] = lanes.params_to_lanes(params.expand(K))
        P = lane_params[K]
        gcT, gvT = xs[:, :19].T.contiguous(), xs[:, 19:].T.contiguous()
        ptT = (us + action_mean).T
        bwT = torch.zeros((6, K), dtype=xs.dtype, device=xs.device)
        for _ in range(mpc_cfg.model_substeps):
            tau = kp * (ptT - gcT[7:]) - kd * gvT[6:]
            tau = torque_clamp(cfg, tau.T, gvT[6:].T).T.contiguous()
            gcT, gvT, *_ = phys_cuda.substep(P, gcT, gvT, tau, bwT, cfg.contact_slip_vel, 0.0,
                                             sub_dt)
        return torch.cat([gcT.T, gvT.T], dim=1)

    return step


def solve_batch_lanes(cfg: EnvConfig, mpc_cfg: MPCConfig, params: mdl.RobotParams,
                      probs: TrotProblem) -> ilqr.ILQRResult:
    """Whole-body iLQR over a problem batch on the lanes physics: the
    optimization of :func:`batched_solve` for one nominal robot, with the
    physics' lane width problems x 2 (37 + 12) during an FD linearization and
    problems x n_alphas in the line search."""
    dynamics_b = make_dynamics_batch(cfg, mpc_cfg, params)
    w = mpc_cfg.weights

    def cost_fn(x, u, arg):
        jref, jdref, command = arg
        return mcost.stage_cost(cfg, w, x, u, jref, jdref, command)

    def term_fn(x, arg):
        jref_last, command = arg
        return mcost.terminal_cost(cfg, w, x, jref_last, command)

    stage_args = (probs.joint_refs, probs.joint_dot_refs, probs.command[:, None, :])
    term_args = (probs.joint_ref_T, probs.command)
    linearize_b = None
    if mpc_cfg.linearizer == "frozen":
        linearize_b = linearize.make_frozen_linearizer(cfg, mpc_cfg, params)
    return ilqr.solve_batch(dynamics_b, cost_fn, term_fn, probs.x0, _u_init(cfg, probs),
                            stage_args, term_args, n_iter=mpc_cfg.n_iter,
                            lin_chunk=mpc_cfg.linearize_chunk, n_alphas=mpc_cfg.n_alphas,
                            relin_every=mpc_cfg.relin_every, fd_eps=mpc_cfg.fd_eps,
                            linearize_b=linearize_b)


def standing_x0(cfg: EnvConfig, device=None) -> torch.Tensor:
    """(37,) stand pose with the toes just touching the ground (the URDF chain
    puts the toe centers 0.277 m under the base; contact at center height =
    toe radius)."""
    gc = mdl.stand_gc(cfg.abad).copy()
    gc[2] = 0.304
    return dev_mod.tensor(list(gc) + [0.0] * 18, dev_mod.resolve(device))
