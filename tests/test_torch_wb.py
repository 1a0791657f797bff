"""PyTorch port: the whole-body trot-MPC against the JAX package.

The tracking cost and its derivatives, ``make_problem``, one step of the
dense MPC model (``make_dynamics``) and of the lanes model
(``make_dynamics_batch``), and the frozen linearizer's A and B, all against
the JAX package live; then ``trot.solve``, ``batched_solve`` and
``solve_batch_lanes`` (frozen and FD) at ``tests/test_mpc.py``'s setup
(horizon 10, 3 iterations, 1 model substep) against JAX results read from
``tests/test_torch_wb_refs.json`` (the JAX solvers' CPU compiles take minutes),
which

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb.py refs

writes from the same inputs. ``... tests/test_torch_wb.py bench`` prints the
JAX references of ``chip_smoke.py``'s phase 13 (``batched_solve`` with the
frozen linearizer at bench.py's whole-body shape, on its 5 distinct problems)
and the port's costs on the CPU beside them; ``... witness`` how far the
lanes solves at that shape move under changes the size of rounding (the
reason phase 13 holds their final costs by no limit).
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import cost as tcost
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr as tilqr
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import linearize as tlin
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import trot as ttrot
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as ttr
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import cost as jcost
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import linearize as jlin
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import trot as jtrot
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import terrain as jtr

torch.set_num_threads(1)

REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_wb_refs.json")
# tests/test_mpc.py's trot setup: horizon 10, 3 iterations, 1 model substep
SMALL = dict(horizon=10, n_iter=3, model_substeps=1)
SMALL_CMDS = (0.5, 1.0, 2.0)
# bench.py's whole-body shape (_bench_ilqr: batch 64, horizon 50, 8 iterations,
# 2 model substeps, linearize_chunk 1, the frozen linearizer); its 64 commands
# 1 + 3 (i % 5) / 4 are these 5 distinct problems, each repeated
BENCH = dict(horizon=50, n_iter=8, model_substeps=2, linearize_chunk=1, linearizer="frozen")
BENCH_CMDS = tuple(1.0 + 3.0 * i / 4.0 for i in range(5))
# solver tolerances against JAX on the CPU, each some 5-20x what the port reads: costs
# relative to themselves (dense solvers 3.3e-6; the lanes warm start 1.6e-6; lanes
# iterations 7.1e-3, see test_solve_batch_lanes_matches_jax), first controls absolute
# (dense 6.8e-6)
SOLVE_RTOL, WARM_RTOL, LANES_RTOL, U0_ATOL = 2e-5, 1e-5, 3e-2, 1e-4


def _close(got, want, rtol: float, what: str = "") -> float:
    """max |got - want| <= rtol * max(1, max |want|); returns that error
    relative to the scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: max |err| {err:.3g} x {scale:.3g} > rtol {rtol}"
    return err


# --- the two sides' setups ---------------------------------------------------------

def _cfgs():
    return (jconfig.test_default().replace(obs_noise=0.0),
            tconfig.test_default().replace(obs_noise=0.0))


def _jax_problems(cfg, mc, cmds, t0=0.0, xy_shift=None):
    x0 = jtrot.standing_x0(cfg)
    cmds = jnp.asarray([[c, 0.0, 0.0] for c in cmds], jnp.float32)
    shift = None if xy_shift is None else jnp.asarray(xy_shift, jnp.float32)
    if shift is None:
        return jax.vmap(lambda c: jtrot.make_problem(
            cfg, x0[:19], jnp.zeros(18), c, jnp.asarray(t0, jnp.float32), mc.horizon))(cmds)
    return jax.vmap(lambda c, s: jtrot.make_problem(
        cfg, x0[:19], jnp.zeros(18), c, jnp.asarray(t0, jnp.float32), mc.horizon, s))(cmds, shift)


def _torch_problems(cfg, mc, cmds, t0=0.0, xy_shift=None):
    B = len(cmds)
    x0 = ttrot.standing_x0(cfg, "cpu")
    command = torch.tensor([[c, 0.0, 0.0] for c in cmds], dtype=torch.float32)
    shift = None if xy_shift is None else torch.tensor(xy_shift, dtype=torch.float32)
    return ttrot.make_problem(cfg, x0[:19].expand(B, 19), torch.zeros(B, 18), command,
                              torch.full((B,), t0), mc.horizon, shift)


def _floats(a) -> list:
    """A float32 array as nested lists of the 9 significant digits that keep
    each float32 value."""
    return np.vectorize(lambda v: float(f"{v:.9g}"))(np.asarray(a, np.float64)).tolist()


def _result(res) -> dict:
    """What a solve is held to: cost traces, final costs, first controls."""
    return {"cost_trace": _floats(res.cost_trace), "cost": _floats(res.cost),
            "u0": _floats(res.us[..., 0, :])}


def _jax_runs(which: str) -> dict:
    """The JAX solves the port is held to (see the module docstring)."""
    jcfg, _ = _cfgs()
    params = jmdl.nominal_params(jcfg)
    out = {}
    if which == "small":
        for lin in ("fd", "frozen"):
            mc = jtrot.MPCConfig(**SMALL, linearizer=lin)
            probs = _jax_problems(jcfg, mc, SMALL_CMDS)
            pb = jax.tree.map(lambda x: jnp.broadcast_to(x, (len(SMALL_CMDS),) + x.shape), params)
            for name, fn in (("batched", lambda pr: jtrot.batched_solve(jcfg, mc, pb, pr)),
                             ("lanes", lambda pr: jtrot.solve_batch_lanes(jcfg, mc, params, pr))):
                t0 = time.time()
                out[f"{name}_{lin}"] = _result(jax.jit(fn)(probs))
                print(f"{name}_{lin}: {time.time() - t0:.0f} s", flush=True)
            warm = dataclasses.replace(mc, n_iter=0)
            out[f"warm_{lin}"] = _floats(jax.jit(
                lambda pr: jtrot.solve_batch_lanes(jcfg, warm, params, pr).cost)(probs))
        mc = jtrot.MPCConfig(**SMALL)
        one = jax.tree.map(lambda x: x[1], _jax_problems(jcfg, mc, SMALL_CMDS))
        out["solve"] = _result(jax.jit(lambda p: jtrot.solve(jcfg, mc, params, p))(one))
    else:
        mc = jtrot.MPCConfig(**BENCH)
        probs = _jax_problems(jcfg, mc, BENCH_CMDS)
        pb = jax.tree.map(lambda x: jnp.broadcast_to(x, (len(BENCH_CMDS),) + x.shape), params)
        for n_iter in (0, mc.n_iter):
            m = dataclasses.replace(mc, n_iter=n_iter)
            t0 = time.time()
            res = jax.jit(lambda pr: jtrot.batched_solve(jcfg, m, pb, pr))(probs)
            out["warm" if n_iter == 0 else "solve"] = _result(res) if n_iter else \
                np.asarray(res.cost, np.float64).tolist()
            print(f"bench n_iter={n_iter}: {time.time() - t0:.0f} s", flush=True)
    return out


# --- cost, problem, one step, the linearizer: against JAX live ----------------------

def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _samples(seed: int, n: int):
    """n states (gc, gv) near the stand pose and controls, both sides' arrays."""
    rng = np.random.default_rng(seed)
    gc = np.tile(np.asarray(jtrot.standing_x0(_cfgs()[0]))[:19], (n, 1))
    gc[:, :2] += rng.uniform(-0.3, 0.3, (n, 2))
    gc[:, 2] += rng.uniform(-0.03, 0.01, n)
    q = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.05, (n, 4))
    gc[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    gc[:, 7:] += rng.uniform(-0.2, 0.2, (n, 12))
    gv = rng.uniform(-0.5, 0.5, (n, 18))
    u = rng.uniform(-0.3, 0.3, (n, 12))
    return [a.astype(np.float32) for a in (np.concatenate([gc, gv], 1), u)]


def test_stage_and_terminal_cost_and_derivatives_match_jax():
    """Values, gradients and Hessian blocks per sample; relative 1e-5 of the
    largest entry (float32 rounding of sums of ~40 squares)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    x, u = _samples(1, 16)
    jref = rng.uniform(-1.0, 1.5, (16, 12)).astype(np.float32)
    jdref = rng.uniform(-5.0, 5.0, (16, 12)).astype(np.float32)
    cmd = rng.uniform(-1.0, 4.0, (16, 3)).astype(np.float32)
    w = jcost.relaxation_weights()
    tw = tcost.CostWeights(**dataclasses.asdict(w))
    _close(tcost.stage_cost(tcfg, tw, _t(x), _t(u), _t(jref), _t(jdref), _t(cmd)).numpy(),
           jax.vmap(lambda *a: jcost.stage_cost(jcfg, w, *a))(x, u, jref, jdref, cmd), 1e-5,
           "relaxation cost")
    for w in (jcost.imitation_weights(),):
        tw = tcost.CostWeights(**dataclasses.asdict(w))
        jstage = lambda x_, u_, a, b, c: jcost.stage_cost(jcfg, w, x_, u_, a, b, c)  # noqa: E731
        want = [jax.jit(jax.vmap(f))(x, u, jref, jdref, cmd) for f in (
            jstage, jax.grad(jstage, 0), jax.grad(jstage, 1), jax.hessian(jstage, 0),
            jax.hessian(jstage, 1), jax.jacfwd(jax.grad(jstage, 1), 0))]
        def tstage(x_, u_):
            return tcost.stage_cost(tcfg, tw, x_, u_, _t(jref), _t(jdref), _t(cmd))
        got = [tstage(_t(x), _t(u)), *tilqr._quadratize(tstage, _t(x), _t(u))]
        for g, wv, name in zip(got, want, ("cost", "cx", "cu", "cxx", "cuu", "cux")):
            _close(g.numpy(), wv, 1e-5, name)
        jterm = lambda x_, a, c: jcost.terminal_cost(jcfg, w, x_, a, c)  # noqa: E731
        want = [jax.jit(jax.vmap(f))(x, jref, cmd)
                for f in (jterm, jax.grad(jterm), jax.hessian(jterm))]
        tterm = lambda x_: tcost.terminal_cost(tcfg, tw, x_, _t(jref), _t(cmd))  # noqa: E731
        got = [tterm(_t(x)), *tilqr._quadratize_terminal(tterm, _t(x))]
        for g, wv, name in zip(got, want, ("terminal", "vx", "vxx")):
            _close(g.numpy(), wv, 1e-5, name)


@pytest.mark.parametrize("shifted", [False, True])
def test_make_problem_matches_jax(shifted):
    """References over the horizon from per-problem gait clocks; with a
    Raibert shift weighted per leg. The joint-rate references divide a
    difference of references by control_dt (relative 1e-4 of the largest)."""
    jcfg, tcfg = _cfgs()
    cmds, t0s = (0.5, 1.0, 2.0, 3.5), (0.0, 0.013, 0.1, 0.047)
    mc = jtrot.MPCConfig(horizon=12)
    shift = (np.random.default_rng(2).uniform(-0.05, 0.05, (4, 2)).astype(np.float32)
             if shifted else None)
    x0 = jtrot.standing_x0(jcfg)
    jc = jnp.asarray([[c, 0.0, 0.0] for c in cmds], jnp.float32)
    jt0 = jnp.asarray(t0s, jnp.float32)
    if shift is None:
        want = jax.vmap(lambda c, t: jtrot.make_problem(jcfg, x0[:19], jnp.zeros(18), c, t, 12))(
            jc, jt0)
    else:
        want = jax.vmap(lambda c, t, s: jtrot.make_problem(
            jcfg, x0[:19], jnp.zeros(18), c, t, 12, s))(jc, jt0, jnp.asarray(shift))
    tx0 = ttrot.standing_x0(tcfg, "cpu")
    got = ttrot.make_problem(tcfg, tx0[:19].expand(4, 19), torch.zeros(4, 18), _t(jc), _t(jt0), 12,
                             None if shift is None else _t(shift))
    for f in jtrot.TrotProblem._fields:
        _close(getattr(got, f).numpy(), getattr(want, f),
               1e-4 if f == "joint_dot_refs" else 1e-6, f)


def _terrain(seed: int, n: int):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jt = jax.vmap(lambda k: jtr.sampled_fractal(k, 0.05))(keys)
    return jt, ttr.at_offsets(_t(jt.offset), 0.05)


@pytest.mark.parametrize("ground", ["flat", "sampled"])
def test_make_dynamics_step_matches_jax(ground):
    """One control step (2 substeps of 1 ms) of the dense MPC model for
    per-problem randomized robots, flat and on the heightmap: relative 2e-5 of
    the largest entry (the substeps' solves of contact forces of ~1e3 N)."""
    jcfg, tcfg = _cfgs()
    n = 6
    x, u = _samples(3, n)
    mc = jtrot.MPCConfig()
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    jp = jax.vmap(lambda k: jmdl.randomize(k, jconfig.train_default()))(keys)
    tp = tmdl.robot_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jt, tt = (None, None) if ground == "flat" else _terrain(3, n)
    if jt is None:
        want = jax.jit(jax.vmap(lambda p, x_, u_: jtrot.make_dynamics(jcfg, mc, p)(x_, u_, 0)))(
            jp, x, u)
    else:
        want = jax.jit(jax.vmap(lambda p, t, x_, u_: jtrot.make_dynamics(jcfg, mc, p, t)(
            x_, u_, 0)))(jp, jt, x, u)
    got = ttrot.make_dynamics(tcfg, ttrot.MPCConfig(), tp, tt)(_t(x), _t(u), None)
    _close(got.numpy(), want, 2e-5, "x'")


def _linearizer_inputs(ground: str):
    """2 knots x 3 problems with per-problem randomized robots, and the terrain
    of the sampled case: the JAX side's arrays and the port's."""
    x, u = _samples(5, 6)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    jp = jax.vmap(lambda k: jmdl.randomize(k, jconfig.train_default()))(keys)
    tp = tmdl.robot_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jt, tt = (None, None) if ground == "flat" else _terrain(5, 3)
    return x.reshape(2, 3, 37), u.reshape(2, 3, 12), jp, tp, jt, tt


def _jax_linearizer(ground: str):
    jcfg, _ = _cfgs()
    X, U, jp, _, jt, _ = _linearizer_inputs(ground)
    mc = jtrot.MPCConfig()
    if jt is None:
        return jax.jit(jax.vmap(lambda p, x_, u_: jlin.make_frozen_linearizer(jcfg, mc, p)(x_, u_),
                                in_axes=(0, 1, 1), out_axes=1))(jp, X, U)
    return jax.jit(jax.vmap(lambda p, t, x_, u_: jlin.make_frozen_linearizer(jcfg, mc, p, t)(
        x_, u_), in_axes=(0, 0, 1, 1), out_axes=1))(jp, jt, X, U)


def _jax_model_steps() -> dict:
    """The JAX sides of the lanes step and the frozen linearizer (XLA's
    compiles of these take a minute on the CPU)."""
    jcfg, _ = _cfgs()
    x, u = _samples(4, 7)
    out = {"lanes_step": _floats(jtrot.make_dynamics_batch(
        jcfg, jtrot.MPCConfig(), jmdl.nominal_params(jcfg))(x, u))}
    for ground in ("flat", "sampled"):
        A, Bm = _jax_linearizer(ground)
        out[f"frozen_{ground}"] = {"A": _floats(A), "B": _floats(Bm)}
    return out


@pytest.fixture(scope="module")
def refs():
    with open(REFS) as f:
        return json.load(f)


def test_make_dynamics_batch_step_matches_jax(refs):
    """One control step of the lanes model on the CPU (the kernel's plain
    version) against the JAX package's lanes model (relative 2e-5)."""
    _, tcfg = _cfgs()
    x, u = _samples(4, 7)
    got = ttrot.make_dynamics_batch(tcfg, ttrot.MPCConfig(),
                                    tmdl.nominal_params(tcfg, device="cpu"))(_t(x), _t(u))
    _close(got.numpy(), refs["lanes_step"], 2e-5, "x'")


@pytest.mark.parametrize("ground", ["flat", "sampled"])
def test_frozen_linearizer_matches_jax(refs, ground):
    """A and B of the frozen-operator surrogate at 2 knots x 3 problems with
    per-problem robots: relative 1e-4 of the largest entry (the contact
    stiffness' entries of ~1e2 beside O(1) ones)."""
    _, tcfg = _cfgs()
    X, U, _, tp, _, tt = _linearizer_inputs(ground)
    got = tlin.make_frozen_linearizer(tcfg, ttrot.MPCConfig(), tp, tt)(_t(X), _t(U))
    want = refs[f"frozen_{ground}"]
    assert float(np.abs(np.asarray(want["A"])).max()) > 10.0
    for g, name in zip(got, ("A", "B")):
        _close(g.numpy(), want[name], 1e-4, name)


# --- the solvers at tests/test_mpc.py's setup: against the embedded JAX results ------

def _small(linearizer: str, n_iter: int = SMALL["n_iter"]):
    _, tcfg = _cfgs()
    mc = ttrot.MPCConfig(**{**SMALL, "n_iter": n_iter}, linearizer=linearizer)
    return (tcfg, mc, tmdl.nominal_params(tcfg, device="cpu"),
            _torch_problems(tcfg, mc, SMALL_CMDS))


def _check_solve(res, want: dict, rtol: float, u0_atol: float | None, what: str) -> None:
    """Finite, never-rising traces; each cost of the trace within ``rtol`` of
    JAX's, relative to itself; the first controls within ``u0_atol``."""
    trace = res.cost_trace.double().numpy()
    assert np.isfinite(trace).all() and torch.isfinite(res.us).all()
    assert (np.diff(trace, axis=-1) <= 1e-6 * trace[..., :1]).all(), what
    np.testing.assert_allclose(trace, want["cost_trace"], rtol=rtol, err_msg=what)
    np.testing.assert_allclose(res.cost.numpy(), want["cost"], rtol=rtol, err_msg=what)
    if u0_atol is not None:
        np.testing.assert_allclose(res.us[..., 0, :].numpy(), want["u0"], rtol=0, atol=u0_atol,
                                   err_msg=what)


def test_trot_solve_matches_jax(refs):
    """trot.solve on the cmd-1 problem with forward-mode AD Jacobians, JAX's
    jacfwd: each cost of the trace within SOLVE_RTOL of JAX's (float32 rounding
    carried through 3 iterations of stiff contact dynamics)."""
    tcfg, mc, params, probs = _small("fd")
    one = ttrot.TrotProblem(*(f[1:2] for f in probs))
    res = ttrot.solve(tcfg, mc, params, one)
    want = {k: np.asarray(v)[None] for k, v in refs["solve"].items()}
    _check_solve(res, want, SOLVE_RTOL, U0_ATOL, "solve")
    assert float(res.cost_trace[0, -1]) < float(refs["warm_fd"][1])


@pytest.mark.parametrize("linearizer", ["fd", "frozen"])
def test_batched_solve_matches_jax(refs, linearizer):
    """batched_solve of 3 problems with per-problem robots (the nominal one
    for each), AD or frozen Jacobians, against JAX's vmap(solve)."""
    tcfg, mc, params, probs = _small(linearizer)
    res = ttrot.batched_solve(tcfg, mc, params.expand(len(SMALL_CMDS)), probs)
    _check_solve(res, refs[f"batched_{linearizer}"], SOLVE_RTOL, U0_ATOL, "batched_solve")


@pytest.mark.parametrize("linearizer", ["fd", "frozen"])
def test_solve_batch_lanes_matches_jax(refs, linearizer):
    """solve_batch_lanes on the plain lanes physics: the warm start's cost
    within WARM_RTOL of JAX's lanes solver, and each iteration's cost within
    LANES_RTOL of it. The first controls are not compared: the two lanes
    physics round otherwise, and a line search then may take another step
    size at a near tie (the port reads 2.4e-3 off on one cost after such a
    pick, 7.1e-3 with FD Jacobians, whose 1 / (2 eps) amplifies the rounding).
    The frozen run's final costs also stand within 5e-2 of JAX's vmap(solve),
    the JAX package's own lanes-vs-vmap tolerance (tests/test_mpc.py); with FD
    Jacobians the two JAX solvers themselves differ by 15 % after 3
    iterations, so that run is held to JAX's lanes solver only."""
    tcfg, mc, params, probs = _small(linearizer)
    warm = ttrot.solve_batch_lanes(tcfg, dataclasses.replace(mc, n_iter=0), params, probs)
    assert warm.cost_trace.shape == (len(SMALL_CMDS), 0)
    np.testing.assert_allclose(warm.cost.numpy(), refs[f"warm_{linearizer}"], rtol=WARM_RTOL)
    res = ttrot.solve_batch_lanes(tcfg, mc, params, probs)
    _check_solve(res, refs[f"lanes_{linearizer}"], LANES_RTOL, None, "solve_batch_lanes")
    if linearizer == "frozen":
        np.testing.assert_allclose(res.cost.numpy(), refs["batched_frozen"]["cost"], rtol=5e-2)


def write_refs() -> None:
    refs = {**_jax_model_steps(), **_jax_runs("small")}
    with open(REFS, "w") as f:
        json.dump(refs, f, separators=(",", ":"))
    print(f"wrote {REFS}")


def bench_reference() -> None:
    """Print chip_smoke.py's phase-13 JAX constants, and the port's dense
    solve on the CPU against them."""
    ref = _jax_runs("bench")
    print("JAX_WB_WARM_COST =", ref["warm"])
    print("JAX_WB_COST =", ref["solve"]["cost"])
    print("JAX_WB_TRACE =", ref["solve"]["cost_trace"])
    _, tcfg = _cfgs()
    mc = ttrot.MPCConfig(**BENCH)
    params = tmdl.nominal_params(tcfg, device="cpu")
    probs = _torch_problems(tcfg, mc, BENCH_CMDS)
    for name, m in (("warm", dataclasses.replace(mc, n_iter=0)), ("solve", mc)):
        t0 = time.time()
        res = ttrot.batched_solve(tcfg, m, params, probs)
        want = np.asarray(ref[name] if name == "warm" else ref[name]["cost"])
        got = res.cost.double().numpy()
        print(f"port dense {name} ({time.time() - t0:.0f} s): {got.tolist()}; relative "
              f"{(np.abs(got - want) / want).tolist()}", flush=True)
        if name == "solve":
            print("port trace", res.cost_trace.double().numpy().tolist())
    for lin in ("frozen", "fd"):
        m = dataclasses.replace(mc, linearizer=lin)
        t0 = time.time()
        res = ttrot.solve_batch_lanes(tcfg, m, params, probs)
        got = res.cost.double().numpy()
        want = np.asarray(ref["solve"]["cost"])
        print(f"port lanes {lin} ({time.time() - t0:.0f} s): {got.tolist()}; relative "
              f"{(np.abs(got - want) / want).tolist()}", flush=True)
        print("port trace", res.cost_trace.double().numpy().tolist(), flush=True)


WITNESS_RUNS = ("frozen", "frozen+", "frozen-", "fd", "fd+", "fd-", "fd64")


def witness(runs=WITNESS_RUNS, n_iter: int = BENCH["n_iter"], fd_eps: float = 1e-3) -> None:
    """How far the lanes solves at bench.py's shape (the 5 distinct problems,
    the plain substep on the CPU) move under changes the size of rounding:
    for each of ``runs`` (linearizer, then "+" / "-" for the start 1e-6 m
    higher / lower, "64" for float64: FD only, the frozen linearizer's
    constants are float32) the final costs, and before them the
    central-FD Jacobians of one control step in float32 against float64, per
    state of the warm start and of the FD solve's result. ``n_iter`` and
    ``fd_eps`` replace the bench's 8 iterations and MPCConfig's step."""
    _, tcfg = _cfgs()
    params = tmdl.nominal_params(tcfg, device="cpu")
    probs = _torch_problems(tcfg, ttrot.MPCConfig(**BENCH), BENCH_CMDS)
    if "jacobians" in runs:
        mc = ttrot.MPCConfig(**{**BENCH, "linearizer": "fd", "n_iter": n_iter, "fd_eps": fd_eps})
        res = ttrot.solve_batch_lanes(tcfg, mc, params, probs)
        warm = ttrot.solve_batch_lanes(tcfg, dataclasses.replace(mc, n_iter=0), params, probs)
        dyn = ttrot.make_dynamics_batch(tcfg, mc, params)
        dyn64 = ttrot.make_dynamics_batch(tcfg, mc, params.map(lambda t: t.double()))
        for name, r in (("warm start", warm), ("FD solve's result", res)):
            X, U = r.xs[:, :-1].reshape(-1, 37), r.us.reshape(-1, 12)
            j32 = torch.cat(tilqr._jacobian_fd(dyn, X, U, mc.fd_eps), -1).double()
            j64 = torch.cat(tilqr._jacobian_fd(dyn64, X.double(), U.double(), mc.fd_eps), -1)
            rel = ((j32 - j64).norm(dim=(-2, -1)) / j64.norm(dim=(-2, -1))).numpy()
            print(f"FD Jacobians at the {name} states ({rel.size}): float32 against float64 "
                  f"relative error median {np.median(rel):.3g}, max {rel.max():.3g}", flush=True)
    for run in runs:
        if run == "jacobians":
            continue
        lin = run.rstrip("+-64")
        p, pr = params, probs
        if run.endswith(("+", "-")):
            dz = 1e-6 if run.endswith("+") else -1e-6
            pr = pr._replace(x0=pr.x0 + dz * torch.eye(37)[2])
        if run.endswith("64"):
            p, pr = params.map(lambda t: t.double()), type(pr)(*[t.double() for t in pr])
        t0 = time.time()
        mc = ttrot.MPCConfig(**{**BENCH, "linearizer": lin, "n_iter": n_iter, "fd_eps": fd_eps})
        res = ttrot.solve_batch_lanes(tcfg, mc, p, pr)
        print(f"lanes {run}, {n_iter} iterations, fd_eps {fd_eps:g} ({time.time() - t0:.0f} s): "
              f"final costs {res.cost.double().numpy().tolist()}", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb.py refs
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb.py bench
    # PYTHONPATH=. python tests/test_torch_wb.py witness [jacobians,frozen,fd+,... [N_ITER [FD_EPS]]]
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "refs":
        write_refs()
    elif sys.argv[1] == "bench":
        bench_reference()
    elif sys.argv[1] == "witness":
        witness(sys.argv[2].split(",") if len(sys.argv) > 2 else ("jacobians",) + WITNESS_RUNS,
                *[f(a) for f, a in zip((int, float), sys.argv[3:])])
