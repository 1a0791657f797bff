"""Multi-GPU PPO training and MPC solving.

Port of ``parallel/train.py``. The JAX package shards every leaf of the
batched env state, the LSTM state, the obs and the dones on the env axis,
replicates the parameters, the optimizer state and the key, and lets XLA
write the reductions. Here :func:`shard_train_state` keeps a rank's block of
every env-axis leaf of a world-1 state and swaps its generators for
rank-block generators (``device.RankBlock``), so the rank draws what its
envs draw at world 1; :func:`make_distributed_update` is the update with its
reductions written out (``algo.ppo``, ``mesh``); and the two solvers take the
whole problem batch, solve the rank's block and all-gather the result, so the
caller sees what the unsharded solve returns. The 37k-parameter policy never
warrants tensor or pipeline parallelism: data parallelism only, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb, trot
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import mesh as pmesh
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl


def _rows(x, lo: int, hi: int):
    """Rows [lo, hi) of every tensor of ``x`` (a tensor, NamedTuple or None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[lo:hi]
    return type(x)(*(_rows(v, lo, hi) for v in x))


def _params_rows(params: mdl.RobotParams, lo: int, hi: int, n: int) -> mdl.RobotParams:
    """Per-env params (a leading axis of ``n`` over the unbatched (13,) mass)
    are sliced; one robot for every env stays whole."""
    if params.mass.dim() == 1:
        return params
    if params.mass.shape[0] != n:
        raise ValueError(f"per-env params of {params.mass.shape[0]} envs, not {n}")
    return params.map(lambda x: x[lo:hi])


def shard_env_state(state: bp.EnvState, lo: int, hi: int, n: int) -> bp.EnvState:
    """Envs [lo, hi) of a batched ``EnvState`` of ``n`` envs: every field
    leads with the env axis (the terrain's NamedTuples too), the params
    unless they are one unbatched robot. The shared heightmap grid is not in
    the state (``phys.terrain.grid``, one a device)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "params":
            out[f.name] = _params_rows(v, lo, hi, n)
        elif isinstance(v, torch.Tensor):
            if v.shape[0] != n:
                raise ValueError(f"EnvState.{f.name} leads with {v.shape[0]}, not {n} envs")
            out[f.name] = v[lo:hi]
        else:
            out[f.name] = _rows(v, lo, hi)
    return dataclasses.replace(state, **out)


def shard_train_state(mesh: pmesh.Mesh, ts: ppo.TrainState) -> ppo.TrainState:
    """This rank's shard of a world-1 ``TrainState`` (every rank builds the
    same one from the same seed): its block of the env state, the LSTM
    state, the obs and the dones; the parameters and the optimizer whole; the
    two generators as rank blocks of themselves."""
    n = ts.obs.shape[0]
    lo, hi = pmesh.block(mesh, n)
    return ts.replace(env_state=shard_env_state(ts.env_state, lo, hi, n),
                      lstm_state=ts.lstm_state[lo:hi], obs=ts.obs[lo:hi], dones=ts.dones[lo:hi],
                      gen_env=dev_mod.RankBlock(ts.gen_env, lo, hi, n),
                      gen_train=dev_mod.RankBlock(ts.gen_train, lo, hi, n))


def make_distributed_update(env_cfg: EnvConfig, ppo_cfg: ppo.PPOConfig,
                            mesh: pmesh.Mesh) -> Callable:
    """The PPO update of a rank's shard (:func:`shard_train_state`) with the
    gradient and metric reductions over the mesh: ``update(ts) -> (ts,
    metrics)``, the metrics global and alike on every rank. Raises unless
    ``env_cfg.num_envs`` splits evenly over the ranks. The JAX package's
    name for ``ppo.make_update_fn`` with a mesh, which ``ppo.learn`` runs."""
    return ppo.make_update_fn(env_cfg, ppo_cfg, mesh)


def _gathered(mesh: pmesh.Mesh, result: NamedTuple) -> NamedTuple:
    return type(result)(*(None if v is None else pmesh.all_gather_cat(mesh, v) for v in result))


def make_distributed_mpc(env_cfg: EnvConfig, mpc_cfg: trot.MPCConfig,
                         mesh: pmesh.Mesh) -> Callable:
    """``solve(params_batch, probs) -> ILQRResult``: the whole-body
    ``trot.batched_solve`` with the problem axis split over the ranks; each
    rank solves its block and gets every problem's result. Raises unless
    the problems split evenly over the ranks."""
    def solve(params_batch: mdl.RobotParams, probs: trot.TrotProblem):
        n = probs.x0.shape[0]
        lo, hi = pmesh.block(mesh, n)
        res = trot.batched_solve(env_cfg, mpc_cfg, _params_rows(params_batch, lo, hi, n),
                                 _rows(probs, lo, hi))
        return _gathered(mesh, res)
    return solve


def make_distributed_srb(env_cfg: EnvConfig, scfg: srb.SRBConfig,
                         mesh: pmesh.Mesh) -> Callable:
    """``solve(probs) -> SRBResult``: the convex SRB ``srb.batched_solve``
    with the scenario axis split over the ranks (evenly, or it raises),
    every result gathered."""
    def solve(probs: srb.SRBProblem):
        lo, hi = pmesh.block(mesh, probs.x0.shape[0])
        return _gathered(mesh, srb.batched_solve(env_cfg, scfg, _rows(probs, lo, hi)))
    return solve
