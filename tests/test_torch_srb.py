"""PyTorch port: the SRB trot-MPC's modules against the JAX package.

``ops/linalg.solve_spd``, the leg FK and its closed-form Jacobian, the
MPC-grade gait profile and Raibert shift, and every piece of ``mpc/srb`` up to
``batched_solve`` on the bench's problem set, each against the JAX function on
the same inputs (numpy from a seed, float32). The JAX batched solves are
compiled once a file (a compile takes ~45 s on the CPU), at horizon 8.

Run as a script, this file prints the JAX references that ``chip_smoke.py``
embeds for its batched-solve phase (8192 problems x horizon 50), and how far
the port's solve on the CPU lies from them::

    JAX_PLATFORMS=cpu python tests/test_torch_srb.py
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime as truntime
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb as tsrb
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg as tlinalg
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait as tgait
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import kinematics as tkin
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import runtime as jruntime
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import srb as jsrb
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops import linalg as jlinalg
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu.robot import gait as jgait
from high_speed_quadrupedal_locomotion_by_irrl_tpu.robot import kinematics as jkin

torch.set_num_threads(1)

HORIZON = 8
N_PROBLEMS = 34


def bench_problems(n: int):
    """The problem set of bench.py:160-163: commands 1-5 m/s in 17 steps,
    gait clocks 3 ms apart, all from rest at the stand height."""
    cmds = np.array([[1.0 + 4.0 * (i % 17) / 16.0, 0.0, 0.0] for i in range(n)], np.float32)
    return cmds, np.arange(n, dtype=np.float32) * np.float32(0.003)


def _configs():
    """(name, JAX env cfg, JAX SRBConfig, port env cfg, port SRBConfig): the
    default solver, and the closed loop's (high_speed_setup)."""
    jc, tc = jconfig.test_default(), tconfig.test_default()
    jenv, jscfg, _ = jruntime.high_speed_setup(jc)
    tenv, tscfg, _ = truntime.high_speed_setup(tc)
    return [("default", jc, jsrb.SRBConfig(horizon=HORIZON), tc, tsrb.SRBConfig(horizon=HORIZON)),
            ("high_speed", jenv, dataclasses.replace(jscfg, horizon=HORIZON),
             tenv, dataclasses.replace(tscfg, horizon=HORIZON))]


@pytest.fixture(scope="module")
def jax_bench_solves():
    """The JAX batched solve of the bench problem set, one compile a config."""
    cmds, t0s = bench_problems(N_PROBLEMS)
    out = {}
    for name, jc, jscfg, _, _ in _configs():
        probs = jax.vmap(lambda c, t: jsrb.standing_problem(jc, c, t))(jnp.asarray(cmds),
                                                                       jnp.asarray(t0s))
        res = jax.jit(lambda p: jsrb.batched_solve(jc, jscfg, p))(probs)
        out[name] = jax.tree.map(np.asarray, res)
    return out


def test_solve_spd_matches_jax():
    rng = np.random.default_rng(0)
    B, n = 64, 13
    a = rng.normal(size=(B, n, n))
    M = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(B, n, 13)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jlinalg.solve_spd))(M, b))
    got = tlinalg.solve_spd(torch.from_numpy(M), torch.from_numpy(b)).numpy()
    # two f32 Cholesky factorizations of matrices with condition numbers up to ~1e3
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(M @ got, b, atol=2e-4 * np.abs(b).max())


def test_solve_spd_raises_on_indefinite():
    M = torch.eye(13).expand(3, 13, 13).clone()
    M[1, 4, 4] = -1.0
    with pytest.raises(torch.linalg.LinAlgError, match="1 of 3"):
        tlinalg.solve_spd(M, torch.ones(3, 13, 2))


def test_leg_fk_and_jacobian_match_jax():
    rng = np.random.default_rng(1)
    q = (np.array([0.0, -0.78, 1.57]) + 0.6 * rng.normal(size=(64, 4, 3))).astype(np.float32)
    is_right = np.asarray(jmdl.IS_RIGHT)
    tq, tr = torch.from_numpy(q), torch.from_numpy(is_right)
    want_fk = np.asarray(jkin.leg_fk(jnp.asarray(q), jnp.asarray(is_right)))
    jac = jax.vmap(jax.vmap(jax.jacfwd(lambda qq, i: jkin.leg_fk(qq, i)), in_axes=(0, 0)),
                   in_axes=(0, None))
    want_J = np.asarray(jac(jnp.asarray(q), jnp.asarray(is_right)))          # (64,4,3,3)
    # the same f32 trigonometry; jacfwd differentiates the same expressions
    np.testing.assert_allclose(tkin.leg_fk(tq, tr).numpy(), want_fk, atol=1e-6)
    np.testing.assert_allclose(tkin.legs_fk(tq.reshape(64, 12)).numpy(),
                               np.asarray(jax.vmap(jkin.legs_fk)(q.reshape(64, 12))), atol=1e-6)
    np.testing.assert_allclose(tkin.leg_jacobian(tq, tr).numpy(), want_J, atol=1e-6)
    np.testing.assert_allclose(tkin.legs_jacobian(tq.reshape(64, 12)).numpy(), want_J, atol=1e-6)


def _gait_inputs(B, seed):
    rng = np.random.default_rng(seed)
    cmd = np.stack([rng.uniform(0.0, 5.5, B), rng.uniform(-0.3, 0.3, B),
                    rng.uniform(-0.5, 0.5, B)], -1).astype(np.float32)
    t = rng.uniform(0.0, 1.0, B).astype(np.float32)
    shift = rng.uniform(-0.05, 0.05, (B, 2)).astype(np.float32)
    return cmd, t, shift


@pytest.mark.parametrize("schedule_vx", [1.0, 5.0])
def test_gait_touchdown_match_and_shift_match_jax(schedule_vx):
    """The MPC-grade profile with a (2,) Raibert shift, under the trot schedule
    of the closed loop at 1 m/s and the flight-phase trot at 5 m/s."""
    jc, _, _ = jruntime.speed_schedule(jconfig.test_default(), schedule_vx)
    tc, _, _ = truntime.speed_schedule(tconfig.test_default(), schedule_vx)
    cmd, t, shift = _gait_inputs(128, 2)
    toe = jax.vmap(lambda c, tt: jgait.toe_targets(jc, c, tt, True))(cmd, t)
    ref = jax.vmap(lambda c, tt, s: jgait.gait_reference(jc, c, tt, s, True))(cmd, t, shift)
    tt_ = torch.from_numpy
    got_toe = tgait.toe_targets(tc, tt_(cmd), tt_(t), touchdown_match=True)
    got = tgait.gait_reference(tc, tt_(cmd), tt_(t), tt_(shift), touchdown_match=True)
    # f32 Bezier and retraction polynomials; IK's arcsin/arccos amplify to ~1e-6 rad
    np.testing.assert_allclose(got_toe.numpy(), np.asarray(toe), atol=1e-6)
    np.testing.assert_allclose(got.toe.numpy(), np.asarray(ref.toe), atol=1e-6)
    np.testing.assert_allclose(got.ee_ref.numpy(), np.asarray(ref.ee_ref), atol=1e-6)
    np.testing.assert_allclose(got.joint_ref.numpy(), np.asarray(ref.joint_ref), atol=2e-5)


def _toe_targets_before(cfg, command, t):
    """toe_targets as the port had it before the MPC options (imitation only)."""
    gait_step = command[..., 0] * cfg.lam * cfg.period
    side_step = command[..., 1] * cfg.lam * cfg.period
    rot_step = command[..., 2] * cfg.period * 0.4
    up = tgait.swing_up_height(cfg, command)
    offsets = torch.tensor(cfg.phase_offsets, dtype=torch.float32)
    phase = torch.remainder(t[..., None] + offsets * cfg.period, cfg.period) / cfg.period
    anti = torch.tensor([1.0, 1.0, -1.0, -1.0])
    half = torch.stack([(gait_step / 2.0)[..., None].expand(phase.shape),
                        side_step[..., None] / 2.0 + anti * rot_step[..., None] / 2.0,
                        torch.full_like(phase, -cfg.stand_height)], dim=-1)
    p_back = torch.stack([-half[..., 0], -half[..., 1], half[..., 2]], dim=-1)
    r_st = phase / cfg.lam
    r_sw = (phase - cfg.lam) / (1.0 - cfg.lam)
    toe_st = half + tgait._bezier_blend(r_st)[..., None] * (p_back - half)
    toe_sw_xy = p_back[..., :2] + tgait._bezier_blend(r_sw)[..., None] * (half[..., :2]
                                                                          - p_back[..., :2])
    toe_sw = torch.cat([toe_sw_xy, (p_back[..., 2] + tgait._gauss(r_sw, 1.0, up[..., None]))
                        [..., None]], dim=-1)
    return torch.where((phase < cfg.lam)[..., None], toe_st, toe_sw)


def test_gait_defaults_unchanged():
    """The env's imitation reference is bit for bit what it was."""
    cfg = tconfig.test_default()
    cmd, t, _ = (torch.from_numpy(x) for x in _gait_inputs(128, 3))
    before = _toe_targets_before(cfg, cmd, t)
    assert torch.equal(tgait.toe_targets(cfg, cmd, t), before)
    ref = tgait.gait_reference(cfg, cmd, t)
    ik_in = before.clone()
    ik_in[..., 1] += torch.tensor(tgait.hip_y_offsets(cfg), dtype=torch.float32)
    assert torch.equal(ref.toe, before)
    assert torch.equal(ref.joint_ref, tkin.legs_ik(ik_in))


def test_srb_constants_match_jax():
    m_t, I_t = tsrb._srb_constants(0.0)
    m_j, I_j = jsrb._srb_constants(0.0)
    # float64 through the port's fk_lanes against the JAX float32 FK
    assert abs(m_t - m_j) < 1e-6 * m_j
    np.testing.assert_allclose(I_t, I_j, atol=1e-6 * np.abs(I_j).max())


def _random_states(B, seed):
    rng = np.random.default_rng(seed)
    gc = np.tile(np.asarray(jmdl.stand_gc(0.0)), (B, 1))
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gv = rng.normal(size=(B, 18))
    return gc.astype(np.float32), gv.astype(np.float32)


def test_problem_pieces_match_jax():
    """stance_mask, make_problem, sweep_command (all three modes) and
    grf_to_torque from random states."""
    B = 32
    jc, tc = jconfig.test_default(), tconfig.test_default()
    rng = np.random.default_rng(4)
    gc, gv = _random_states(B, 5)
    cmd, t, _ = _gait_inputs(B, 6)
    tt_ = torch.from_numpy
    np.testing.assert_array_equal(
        tsrb.stance_mask(tc, tt_(t)).numpy(),
        np.asarray(jax.vmap(lambda x: jsrb.stance_mask(jc, x))(t)))

    jp = jax.vmap(lambda g, v, c, x: jsrb.make_problem(jc, g, v, c, x))(gc, gv, cmd, t)
    tp = tsrb.make_problem(tc, tt_(gc), tt_(gv), tt_(cmd), tt_(t))
    for name in jp._fields:   # atan2/asin of f32 rotation entries
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   atol=2e-6, err_msg=name)
    for mode in ("command", "measured", "planned"):
        for gain in (1.0, 1.3):
            js = jsrb.SRBConfig(sweep_mode=mode, sweep_gain=gain)
            ts = tsrb.SRBConfig(sweep_mode=mode, sweep_gain=gain)
            want = jax.vmap(lambda p: jsrb.sweep_command(jc, js, p))(jp)
            np.testing.assert_allclose(tsrb.sweep_command(tc, ts, tp).numpy(), np.asarray(want),
                                       atol=2e-6, err_msg=mode)

    f = np.stack([rng.normal(0, 20, (B, 4)), rng.normal(0, 20, (B, 4)),
                  rng.uniform(0, 120, (B, 4))], -1).astype(np.float32)
    sm = (rng.uniform(size=(B, 4)) < 0.5).astype(np.float32)
    for stance_pd, swing_pd in ((0.0, 1.0), (1.0, 1.0), (0.2, 1.5)):
        want = jax.vmap(lambda g, ff, s: jsrb.grf_to_torque(jc, g, ff, s, stance_pd, swing_pd))(
            gc, f, sm)
        got = tsrb.grf_to_torque(tc, tt_(gc), tt_(f), tt_(sm), stance_pd, swing_pd)
        # J^T f of forces up to 120 N through f32 trigonometry
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("which", ["default", "high_speed"])
def test_batched_solve_matches_jax(jax_bench_solves, which):
    """batched_solve on the bench's problem set (34 problems, horizon 8)."""
    _, _, _, tc, tscfg = next(c for c in _configs() if c[0] == which)
    cmds, t0s = bench_problems(N_PROBLEMS)
    probs = tsrb.standing_problem(tc, torch.from_numpy(cmds), torch.from_numpy(t0s))
    got = tsrb.batched_solve(tc, tscfg, probs)
    want = jax_bench_solves[which]
    assert got.forces.shape == (N_PROBLEMS, HORIZON, 4, 3)
    assert got.xs.shape == (N_PROBLEMS, HORIZON + 1, 13)
    assert got.us.shape == (N_PROBLEMS, HORIZON, 12) and got.cost.shape == (N_PROBLEMS,)
    # batched f32 products and a LAPACK Cholesky against XLA's unrolled scalar
    # sweep: measured 2.3e-5 N on forces of ~60 N, 5e-8 on xs, 1.2e-6 on us
    np.testing.assert_allclose(got.forces.numpy(), want.forces, atol=5e-4, rtol=1e-5)
    np.testing.assert_allclose(got.xs.numpy(), want.xs, atol=1e-6)
    np.testing.assert_allclose(got.us.numpy(), want.us, atol=1e-5)
    np.testing.assert_allclose(got.cost.numpy(), want.cost, rtol=1e-5)
    assert (want.forces[..., 2] > 1.0).any() and (want.forces[..., 2] == 0).any()


def test_solve_without_controls_plans_the_same_forces():
    tc, tscfg = tconfig.test_default(), tsrb.SRBConfig(horizon=HORIZON)
    cmds, t0s = bench_problems(5)
    probs = tsrb.standing_problem(tc, torch.from_numpy(cmds), torch.from_numpy(t0s))
    full, bare = (tsrb.solve(tc, tscfg, probs, controls=c) for c in (True, False))
    assert bare.us is None
    for name in ("forces", "xs", "cost"):
        assert torch.equal(getattr(full, name), getattr(bare, name))


def bench_reference(batch: int = 8192, horizon: int = 50, first: int = 17,
                    chunk: int = 1024) -> dict:
    """What chip_smoke.py holds its batched-solve phase to: the JAX solve of
    bench.py's problem set on the CPU (in chunks: problems are independent).
    The mean, min and max cost over all problems; a row for each of the
    first ``first`` problems: cost, the forces (12) and us (12) of knot 0, and
    the 2-norms of the whole force and us sequences; the problems whose cost
    the port's solve on the CPU puts more than 1e-4 relative away (a knot's
    gait clock on a phase boundary up to rounding, which XLA's fused graph and
    eager PyTorch round to either side); and, with
    those left out, the sum of the costs of each ``chunk`` problems."""
    cfg, tc = jconfig.test_default(), tconfig.test_default()
    scfg = jsrb.SRBConfig(horizon=horizon)
    cmds, t0s = bench_problems(batch)
    probs = jax.vmap(lambda c, t: jsrb.standing_problem(cfg, c, t))(jnp.asarray(cmds),
                                                                     jnp.asarray(t0s))
    solve = jax.jit(lambda p: jsrb.batched_solve(cfg, scfg, p))
    costs, port, head = [], [], None
    for s in range(0, batch, chunk):
        r = jax.tree.map(np.asarray, solve(jax.tree.map(lambda x: x[s:s + chunk], probs)))
        costs.append(r.cost)
        head = r if head is None else head
        p = tsrb.standing_problem(tc, torch.from_numpy(cmds[s:s + chunk]),
                                  torch.from_numpy(t0s[s:s + chunk]))
        port.append(tsrb.batched_solve(tc, tsrb.SRBConfig(horizon=horizon), p).cost.numpy())
    cost, port = np.concatenate(costs), np.concatenate(port)
    f, us = head.forces[:first].reshape(first, horizon, 12), head.us[:first]
    rows = np.concatenate([head.cost[:first, None], f[:, 0], us[:, 0],
                           np.linalg.norm(f.reshape(first, -1), axis=1)[:, None],
                           np.linalg.norm(us.reshape(first, -1), axis=1)[:, None]], axis=1)
    rel = np.abs(port - cost) / cost
    boundary = np.nonzero(rel > 1e-4)[0]
    kept = np.ones(batch, bool)
    kept[boundary] = False
    sums = [float(cost[s:s + chunk][kept[s:s + chunk]].astype(np.float64).sum())
            for s in range(0, batch, chunk)]
    spread = (f"{len(boundary)} of {batch} costs differ by more than 1e-4 relative (at most "
              f"{rel.max():.3g}); the others by at most {rel[kept].max():.3g}; mean "
              f"{port.mean() / cost.mean() - 1:+.3g}, min {port.min() / cost.min() - 1:+.3g}, "
              f"max {port.max() / cost.max() - 1:+.3g} relative")
    return {"cost_mean": float(cost.mean()), "cost_min": float(cost.min()),
            "cost_max": float(cost.max()), "rows": rows.tolist(),
            "boundary": boundary.tolist(), "chunk_sums": sums, "spread": spread}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_srb.py
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    ref = bench_reference()
    print("port on the CPU against JAX:", ref["spread"])
    print(f"cost_mean={ref['cost_mean']!r}, cost_min={ref['cost_min']!r}, "
          f"cost_max={ref['cost_max']!r}")
    print(f"JAX_SRB_BOUNDARY = {ref['boundary']}")
    print(f"JAX_SRB_CHUNK_SUMS = {ref['chunk_sums']}")
    for row in ref["rows"]:
        print("[" + ", ".join(f"{x:.7g}" for x in row) + "],")
