"""PyTorch port: the whole-body receding-horizon loop against the JAX package.

``mpc/runtime.wb_speed_schedule`` against JAX's; the port's loop
(``wb_mpc_rollout``, ``_chunked``, ``_batch``) on the CPU, whose env step is
``step_batch`` (the physics kernel's plain version here), against the JAX
loop with the same env step: JAX's ``_make_wb_scan`` with its per-env
``bp.step`` swapped for its lanes ``step_batch`` (:func:`jax_loop`), from
JAX's start; the flat and the terrain model; the CLI; and
``analysis/parity.mpc_vs_bp5``. JAX's loop compiles for minutes on the CPU,
so its side is read from ``tests/test_torch_wb_loop_refs.json``, which

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py refs

writes from the same inputs. Two more script modes:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py witness NMAX N[,N...]

runs JAX's own loop (per-env ``bp.step``) and the lanes loop at
``wb_speed_schedule`` for cmd 1-5 over NMAX steps, each also from a start
1e-6 m higher and lower, then ``mpc_vs_bp5`` at cmd 1 (its solve also from
the nudged starts) and a 25-step terrain-model loop, and prints for each N
the constants ``chip_smoke.py``'s phase 14 holds the port to, with JAX's
nudge spreads; ``... parity`` prints the ``mpc_vs_bp5`` part alone, with
the cost traces of JAX's solve and of the port's on the CPU from JAX's start,
each also nudged; ``... table [STEPS] [1,2,3,4,5]`` prints JAX's own
``cli/mpc.py --engine wb`` rows (chunked harness, JAX on the CPU; default
2500 steps).
"""

import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import parity as tparity
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import rawdata as trawdata
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import mpc as tcli
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr as tilqr
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime as truntime
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import trot as ttrot
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import parity as jparity
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import runtime as jruntime
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import trot as jtrot
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl

torch.set_num_threads(1)

REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_wb_loop_refs.json")
ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
# tests/test_mpc.py's receding-horizon setup, with 3 knots linearized at a time
SMALL = dict(horizon=6, n_iter=1, model_substeps=2, linearize_chunk=3, n_alphas=4)
CMD = 1.0
LOOP_STEPS, SHORT_STEPS, TERRAIN_STEPS, CLI_STEPS = 20, 6, 5, 5
TERRAIN_Z = 0.05
PARITY = dict(horizon=4, warmup=20, n_iter=2)
NUDGE_M = 1e-6
# Tolerances. The loop: gc within GC_ATOL of the JAX lanes loop at every step
# and each solve's cost within COST_RTOL of JAX's, relative to itself (the port
# reads <= 7.2e-7 and <= 8.4e-7); the applied actions within ACTION_ATOL (it reads
# 2.2e-5: the first knot's control carries the gains' amplified rounding). A batch
# row against the same command alone within BATCH_ATOL (JAX's own fleet test,
# tests/test_mpc.py; the port reads 3.5e-10 on gc, 1.2e-7 on actions).
GC_ATOL, COST_RTOL, ACTION_ATOL, BATCH_ATOL = 1e-4, 1e-4, 1e-4, 1e-4
# mpc_vs_bp5 from JAX's start: the plan's controls within PLAN_ATOL (it reads 2.3e-5)
# and its cost within COST_RTOL (2.6e-7); end to end, the port's own 25 policy
# steps' actions within BP5_ATOL (1.3e-7) and mae, torque_mae within MAE_ATOL
# (4.9e-7, 0)
PLAN_ATOL, BP5_ATOL, MAE_ATOL = 1e-4, 1e-5, 1e-4


# --- the JAX side ------------------------------------------------------------------

def _deploy(cfg):
    return cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0, stochastic_dynamics=False)


def _lanes_step(cfg, state, action):
    """JAX's env step of one env through its lanes physics (step_batch)."""
    out = jbp.step_batch(cfg, jax.tree.map(lambda x: x[None], state), action[None])
    return jax.tree.map(lambda x: x[0], out)


_LOOPS: dict = {}


def jax_loop(cfg, mc, command, n_steps: int, physics: str = "lanes",
             terrain_model: bool = False, dz: float = 0.0) -> dict:
    """JAX's whole-body loop (``runtime._make_wb_scan``, the body of
    ``wb_mpc_rollout``) from ``_wb_init_carry``'s start raised by ``dz``
    metres, with the env stepped by JAX's per-env ``bp.step`` ("per_env":
    its own loop) or by its lanes ``step_batch`` ("lanes": the port's path).
    -> numpy gc, gv, action, solve_cost, done (n_steps, ...)."""
    cfg = _deploy(cfg)
    command = jnp.asarray(command, jnp.float32)
    state, us = jruntime._wb_init_carry(cfg, mc, command, jax.random.PRNGKey(0))
    state = state._replace(gc=state.gc.at[2].add(dz))
    k = (cfg, mc, n_steps, physics, terrain_model)
    if k not in _LOOPS:
        def run(command, carry):
            terrain = carry[0].terrain if terrain_model else None
            return jax.lax.scan(jruntime._make_wb_scan(cfg, mc, command, 0.0, terrain), carry,
                                None, length=n_steps)[1]
        _LOOPS[k] = jax.jit(run)
    saved = jbp.step
    if physics == "lanes":       # the scan body is traced under the swap
        jbp.step = _lanes_step
    try:
        log = _LOOPS[k](command, (state, us))
    finally:
        jbp.step = saved
    return {f: np.asarray(getattr(log, f)) for f in ("gc", "gv", "action", "solve_cost", "done")}


def _v_forward(log: dict) -> np.ndarray:
    return np.asarray(jev.body_velocity(SimpleNamespace(gc=log["gc"], gv=log["gv"])))[:, 0]


def _floats(a) -> list:
    """float32 values as nested lists of the 9 significant digits that keep them."""
    return np.vectorize(lambda v: float(f"{v:.9g}"))(np.asarray(a, np.float64)).tolist()


def _small_mc(lin: str):
    return jtrot.MPCConfig(**SMALL, linearizer=lin)


def _terrain_cfg(mod):
    return mod.test_default().replace(terrain=True, crucial=False, terrain_z_scale=TERRAIN_Z)


def _jax_parity(cfg, params, command_vx, horizon, warmup, mpc_cfg, dz=0.0):
    """``parity.mpc_vs_bp5`` with the solve's start raised by ``dz`` (0: the
    JAX function itself), and the state it solves from."""
    cfg = _deploy(cfg)
    if dz == 0.0:
        r = jparity.mpc_vs_bp5(cfg, params, command_vx, horizon, warmup, mpc_cfg)
    log = jev.policy_rollout(cfg, params, jnp.array([command_vx, 0.0, 0.0]),
                             jax.random.PRNGKey(0), warmup + mpc_cfg.horizon + 1)
    gc0, gv0 = log.gc[warmup - 1], log.gv[warmup - 1]
    prob = jtrot.make_problem(cfg, gc0.at[2].add(dz), gv0, jnp.array([command_vx, 0.0, 0.0]),
                              jnp.asarray(warmup * cfg.control_dt), mpc_cfg.horizon)
    res = jax.jit(lambda p: jtrot.solve(cfg, mpc_cfg, jmdl.nominal_params(cfg), p))(prob)
    if dz != 0.0:
        bp5_u = np.asarray(log.action[warmup:warmup + mpc_cfg.horizon])
        mpc_u = np.clip(np.asarray(res.us), -1.0, 1.0)
        stand = np.asarray(jmdl.stand_gc(cfg.abad)[7:])
        xs = np.asarray(res.xs)
        tau_mpc = cfg.stiffness * (mpc_u + stand - xs[:-1, 7:19]) - cfg.damping * xs[:-1, 25:]
        q = np.asarray(log.gc[warmup:warmup + mpc_cfg.horizon, 7:])
        qd = np.asarray(log.gv[warmup:warmup + mpc_cfg.horizon, 6:])
        tau_bp5 = cfg.stiffness * (bp5_u + stand - q) - cfg.damping * qd
        r = jparity.ParityResult(mae=float(np.abs(mpc_u - bp5_u).mean()),
                                 torque_mae=float((np.abs(tau_mpc - tau_bp5)
                                                   / np.asarray(jmdl.TORQUE_LIMIT_J)).mean()),
                                 bp5_actions=bp5_u, mpc_actions=mpc_u)
    return r, np.asarray(gc0), np.asarray(gv0), res


def write_refs() -> None:
    out = {}
    jcfg = jconfig.test_default()
    for lin in ("frozen", "fd"):
        t0 = time.time()
        log = jax_loop(jcfg, _small_mc(lin), [CMD, 0.0, 0.0], LOOP_STEPS)
        out[f"loop_{lin}"] = {k: _floats(log[k]) for k in ("gc", "solve_cost", "action")}
        print(f"loop {lin}: {time.time() - t0:.0f} s", flush=True)
    t0 = time.time()
    tcfg = _terrain_cfg(jconfig)
    state = jbp.env_init(_deploy(tcfg), jax.random.PRNGKey(0))
    log = jax_loop(tcfg, _small_mc("frozen"), [CMD, 0.0, 0.0], TERRAIN_STEPS, terrain_model=True)
    out["terrain"] = {"offset": _floats(state.terrain.offset),
                      **{k: _floats(log[k]) for k in ("gc", "solve_cost")}}
    print(f"terrain: {time.time() - t0:.0f} s", flush=True)
    t0 = time.time()
    env, mc = jruntime.wb_speed_schedule(jcfg, CMD)
    out["cli"] = {"gc": _floats(jax_loop(env, mc, [CMD, 0.0, 0.0], CLI_STEPS)["gc"])}
    print(f"cli: {time.time() - t0:.0f} s", flush=True)
    t0 = time.time()
    mc = jtrot.MPCConfig(horizon=PARITY["horizon"], n_iter=PARITY["n_iter"])
    r, gc0, gv0, res = _jax_parity(jcfg, jio.load_bp5_csv(ARTIFACT), CMD, PARITY["horizon"],
                                   PARITY["warmup"], mc)
    out["parity"] = {"mae": r.mae, "torque_mae": r.torque_mae, "gc0": _floats(gc0),
                     "gv0": _floats(gv0), "us": _floats(res.us), "cost": float(res.cost),
                     "bp5_actions": _floats(r.bp5_actions)}
    print(f"parity: {time.time() - t0:.0f} s", flush=True)
    with open(REFS, "w") as f:
        json.dump(out, f, separators=(",", ":"))
    print(f"wrote {REFS}")


# --- the port's side ---------------------------------------------------------------

@pytest.fixture(scope="module")
def refs():
    with open(REFS) as f:
        return json.load(f)


def _port_mc(lin: str):
    return ttrot.MPCConfig(**SMALL, linearizer=lin)


def _cmd():
    return np.array([CMD, 0.0, 0.0], np.float32)


def _check_loop(log, want: dict, n: int, what: str) -> None:
    """gc at every step within GC_ATOL, each solve's cost within COST_RTOL."""
    gc = np.asarray(log.gc)[:n]
    cost = np.asarray(log.solve_cost)[:n]
    assert np.isfinite(gc).all() and not np.asarray(log.done).any(), what
    np.testing.assert_allclose(gc, np.asarray(want["gc"])[:n], rtol=0, atol=GC_ATOL, err_msg=what)
    np.testing.assert_allclose(cost, np.asarray(want["solve_cost"])[:n], rtol=COST_RTOL,
                               err_msg=what)


def test_wb_speed_schedule_matches_jax():
    jcfg, tcfg = jconfig.test_default(), tconfig.test_default()
    for vx in (1.0, 2.0, 3.0, 4.0, 5.0):
        jenv, jmc = jruntime.wb_speed_schedule(jcfg, vx)
        tenv, tmc = truntime.wb_speed_schedule(tcfg, vx)
        for f in ("period", "lam", "crucial", "terrain"):
            assert getattr(tenv, f) == getattr(jenv, f), (vx, f)
        for f in ("horizon", "n_iter", "model_substeps", "linearize_chunk", "n_alphas",
                  "relin_every", "linearizer"):
            assert getattr(tmc, f) == getattr(jmc, f), (vx, f)
        assert dataclasses.asdict(tmc.weights) == dataclasses.asdict(jmc.weights)


@pytest.fixture(scope="module")
def frozen_loop():
    """The port's loop at SMALL with the frozen linearizer: LOOP_STEPS steps
    at CMD, one segment."""
    return truntime.wb_mpc_rollout(tconfig.test_default(), _port_mc("frozen"), _cmd(),
                                   torch.Generator(), LOOP_STEPS, device="cpu")


@pytest.mark.parametrize("linearizer", ["frozen", "fd"])
def test_wb_loop_matches_jax_lanes_loop(refs, frozen_loop, linearizer):
    """LOOP_STEPS closed-loop steps at CMD from JAX's start (the stand pose of
    the manual reset: no key draw reaches it), with the frozen linearizer
    (one segment) and with forward-mode AD Jacobians (JAX's jacfwd; through
    the chunked harness, 7-step segments)."""
    if linearizer == "frozen":
        log = frozen_loop
    else:
        log = truntime.wb_mpc_rollout_chunked(tconfig.test_default(), _port_mc("fd"), _cmd(),
                                              torch.Generator(), LOOP_STEPS, chunk=7,
                                              device="cpu")
    assert log.gc.shape == (LOOP_STEPS, 19) and log.solve_cost.shape == (LOOP_STEPS,)
    _check_loop(log, refs[f"loop_{linearizer}"], LOOP_STEPS, linearizer)
    np.testing.assert_allclose(np.asarray(log.action), refs[f"loop_{linearizer}"]["action"],
                               rtol=0, atol=ACTION_ATOL)


def test_wb_batch_row_equals_the_command_alone(frozen_loop):
    """The fleet form: each robot of a 2-command batch computes what its
    command computes alone (JAX's test_wb_mpc_fleet_batch_matches_single)."""
    cmds = np.array([[0.5, 0.0, 0.0], [CMD, 0.0, 0.0]], np.float32)
    batch = truntime.wb_mpc_rollout_batch(tconfig.test_default(), _port_mc("frozen"), cmds,
                                          torch.Generator(), 4, device="cpu")
    assert batch.gc.shape == (2, 4, 19) and batch.solve_cost.shape == (2, 4)
    assert not batch.done.any()
    for f in ("gc", "action", "solve_cost"):
        np.testing.assert_allclose(getattr(batch, f)[1].numpy(), getattr(frozen_loop, f)[:4]
                                   .numpy(), rtol=0, atol=BATCH_ATOL, err_msg=f)


def test_wb_chunked_equals_one_segment_and_builds_the_linearizer_once(frozen_loop, monkeypatch):
    """SHORT_STEPS steps in segments of 4 (a ragged last one), bit for bit the
    one-segment rollout's first SHORT_STEPS; the frozen linearizer is built
    and wrapped for replay once for the rollout, not once a step or segment."""
    built = {"linearizer": 0, "replayed": 0}
    make, init = ttrot.make_linearize_fn, tilqr.Replayed.__init__

    def counted_make(*a, **kw):
        built["linearizer"] += 1
        return make(*a, **kw)

    def counted_init(self, fn):
        built["replayed"] += 1
        init(self, fn)
    monkeypatch.setattr(ttrot, "make_linearize_fn", counted_make)
    monkeypatch.setattr(tilqr.Replayed, "__init__", counted_init)
    log = truntime.wb_mpc_rollout_chunked(tconfig.test_default(), _port_mc("frozen"), _cmd(),
                                          torch.Generator(), SHORT_STEPS, chunk=4, device="cpu")
    assert built == {"linearizer": 1, "replayed": 1}
    for f in truntime.WBMPCRolloutLog._fields:
        got = getattr(log, f)
        assert isinstance(got, np.ndarray) and got.shape[0] == SHORT_STEPS, f
        np.testing.assert_array_equal(got, getattr(frozen_loop, f)[:SHORT_STEPS].numpy(),
                                      err_msg=f)


def test_wb_terrain_model_matches_jax_lanes_loop(refs):
    """terrain_model=True on a sampled-terrain config: the MPC model's contact
    reads the env's own heightmap, at JAX's map offset."""
    want = refs["terrain"]
    log = truntime.wb_mpc_rollout(_terrain_cfg(tconfig), _port_mc("frozen"), _cmd(),
                                  torch.Generator(), TERRAIN_STEPS, terrain_model=True,
                                  device="cpu", terrain_offset=np.asarray([want["offset"]]))
    _check_loop(log, want, TERRAIN_STEPS, "terrain model")


def test_cli_mpc_wb_with_dump_info(refs, tmp_path, capsys):
    """cli.mpc --engine wb on the CPU: JAX's row, and the info CSV with zero
    torque (the whole-body log has none, as in the JAX CLI) and toe-height
    contacts; the joint angles those of JAX's loop at wb_speed_schedule."""
    path = str(tmp_path / "info.csv")
    res = tcli.main(["--engine", "wb", "--steps", str(CLI_STEPS), "--device", "cpu",
                     "--dump-info", path])
    (row,) = res["rows"]
    assert row["command"] == CMD and row["falls"] == 0 and np.isfinite(row["v_mean"])
    assert row["period"] == 0.20 and np.isfinite(row["solve_cost"])
    assert "cmd  1.0 m/s -> v" in capsys.readouterr().out
    info = trawdata.RobotInfo(path)
    assert info.q.shape == (CLI_STEPS, 12) and info.contact.shape == (CLI_STEPS, 4)
    assert not info.tau.any() and set(np.unique(info.contact)) <= {0.0, 1.0}
    np.testing.assert_allclose(info.q, np.asarray(refs["cli"]["gc"])[:, 7:], rtol=0,
                               atol=GC_ATOL)


def test_cli_mpc_wb_viewer_raises(tmp_path, monkeypatch):
    """``--engine wb --viewer`` writes the whole-body rollout as JAX's viewer
    does (the helper of test_torch_mpc.py)."""
    from test_torch_mpc import cli_viewer_matches_jax
    cli_viewer_matches_jax(["--engine", "wb", "--steps", "2"], tmp_path, monkeypatch)


def test_wb_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, mc = truntime.wb_speed_schedule(tconfig.test_default(), CMD)
    for call in (lambda: tcli.main(["--engine", "wb", "--steps", "1"]),
                 lambda: truntime.wb_mpc_rollout(env, mc, _cmd(), torch.Generator(), 1),
                 lambda: truntime.wb_mpc_rollout_chunked(env, mc, _cmd(), torch.Generator(), 1),
                 lambda: truntime.wb_mpc_rollout_batch(env, mc, _cmd()[None], torch.Generator(), 1),
                 lambda: tparity.mpc_vs_bp5(tconfig.test_default(), None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_mpc_vs_bp5_matches_jax(refs):
    """From JAX's start (its policy's state at warmup - 1): the plan of the
    AD-linearized dense solve; end to end: the port's own policy rollout and
    solve, mae and torque_mae."""
    want = refs["parity"]
    tcfg = tconfig.test_default()
    mc = ttrot.MPCConfig(horizon=PARITY["horizon"], n_iter=PARITY["n_iter"])
    x0 = torch.tensor([want["gc0"] + want["gv0"]], dtype=torch.float32)
    prob = ttrot.make_problem(tcfg, x0[:, :19], x0[:, 19:], torch.tensor([[CMD, 0.0, 0.0]]),
                              torch.tensor([PARITY["warmup"] * tcfg.control_dt]), mc.horizon)
    res = ttrot.solve(tcfg, mc, tmdl.nominal_params(tcfg, "cpu"), prob)
    np.testing.assert_allclose(res.us[0].numpy(), want["us"], rtol=0, atol=PLAN_ATOL)
    np.testing.assert_allclose(float(res.cost[0]), want["cost"], rtol=COST_RTOL)

    got = tparity.mpc_vs_bp5(tcfg, tio.load_bp5_csv(ARTIFACT, device="cpu"), CMD,
                             horizon=PARITY["horizon"], warmup=PARITY["warmup"],
                             mpc_cfg=mc, device="cpu")
    assert got.mpc_actions.shape == got.bp5_actions.shape == (PARITY["horizon"], 12)
    np.testing.assert_allclose(got.bp5_actions, want["bp5_actions"], rtol=0, atol=BP5_ATOL)
    assert abs(got.mae - want["mae"]) <= MAE_ATOL, (got.mae, want["mae"])
    assert abs(got.torque_mae - want["torque_mae"]) <= MAE_ATOL, (got.torque_mae,
                                                                  want["torque_mae"])


# --- chip_smoke.py's phase-14 references, and JAX's table -------------------------------

def witness(n_max: int, ns: list) -> None:
    """Print chip_smoke.py's phase-14 JAX constants at each N of ``ns``, from
    one run of n_max steps per loop (see the module docstring)."""
    jcfg = jconfig.test_default()
    runs = {}
    for vx in (1.0, 2.0, 3.0, 4.0, 5.0):
        env, mc = jruntime.wb_speed_schedule(jcfg, vx)
        for physics in ("per_env", "lanes"):
            for dz in (0.0, NUDGE_M, -NUDGE_M):
                t0 = time.time()
                runs[vx, physics, dz] = jax_loop(env, mc, [vx, 0.0, 0.0], n_max, physics, dz=dz)
                print(f"cmd {vx:g} {physics} dz {dz:g}: {time.time() - t0:.0f} s", flush=True)
    for n in ns:
        table, bases = {}, {}
        for vx in (1.0, 2.0, 3.0, 4.0, 5.0):
            v = {k: float(_v_forward({f: x[:n] for f, x in log.items()})[int(n * 0.6):].mean())
                 for k, log in runs.items() if k[0] == vx}
            falls = {k: int(log["done"][:n].sum()) for k, log in runs.items() if k[0] == vx}
            spread = max(abs(v[vx, p, dz] - v[vx, p, 0.0]) for p in ("per_env", "lanes")
                         for dz in (NUDGE_M, -NUDGE_M))
            lanes, per_env = runs[vx, "lanes", 0.0], runs[vx, "per_env", 0.0]
            d = np.abs(lanes["gc"][:n, :3] - per_env["gc"][:n, :3]).max(axis=1)
            hit = np.nonzero(d > 1e-3)[0]
            table[vx] = {"v_lanes": v[vx, "lanes", 0.0], "v_per_env": v[vx, "per_env", 0.0],
                         "falls_lanes": falls[vx, "lanes", 0.0],
                         "falls_per_env": falls[vx, "per_env", 0.0], "nudge_spread": spread,
                         "cost_lanes": float(lanes["solve_cost"][:n].mean()),
                         "lanes_vs_per_env_first_1e-3": int(hit[0]) if len(hit) else None}
            bases[vx] = _floats(lanes["gc"][:min(n, 40), :3])
        print(f"N = {n}:\nJAX_WB_TABLE = {table}\nJAX_WB_BASES = {bases}", flush=True)
    parity_witness()
    t0 = time.time()
    env, mc = jruntime.wb_speed_schedule(jcfg, 1.0)
    env = env.replace(terrain=True, terrain_z_scale=TERRAIN_Z)
    state = jbp.env_init(_deploy(env), jax.random.PRNGKey(0))
    log = jax_loop(env, mc, [1.0, 0.0, 0.0], 25, terrain_model=True)
    print(f"terrain ({time.time() - t0:.0f} s):\nJAX_WB_TERRAIN = "
          f"{ {'offset': _floats(state.terrain.offset), 'bases': _floats(log['gc'][:, :3]), 'falls': int(log['done'].sum())} }",
          flush=True)


def parity_witness() -> None:
    """mpc_vs_bp5 at cmd 1 (warmup 200, MPCConfig(horizon=50)): JAX's mae,
    torque_mae and final cost with the start of its solve as it is and 1e-6 m
    higher and lower, each solve's cost trace; then the port's solve on the
    CPU from JAX's start, as it is and nudged alike, beside them."""
    t0 = time.time()
    jcfg = jconfig.test_default()
    par = {dz: _jax_parity(jcfg, jio.load_bp5_csv(ARTIFACT), 1.0, 50, 200,
                           jtrot.MPCConfig(horizon=50), dz) for dz in (0.0, NUDGE_M, -NUDGE_M)}
    r, gc0, gv0, res = par[0.0]
    spread = {k: max(abs(getattr(par[dz][0], k) - getattr(r, k)) for dz in (NUDGE_M, -NUDGE_M))
              for k in ("mae", "torque_mae")}
    print(f"mpc_vs_bp5 ({time.time() - t0:.0f} s):\nJAX_MPC_VS_BP5 = "
          f"{ {'mae': r.mae, 'torque_mae': r.torque_mae, 'cost': float(res.cost)} }\n"
          f"JAX_MPC_VS_BP5_X0 = {_floats(np.concatenate([gc0, gv0]))}\n"
          f"JAX_MPC_VS_BP5_SPREAD = {spread}", flush=True)
    for dz in (0.0, NUDGE_M, -NUDGE_M):
        print(f"JAX dz {dz:g}: mae {par[dz][0].mae!r}, torque_mae {par[dz][0].torque_mae!r}, "
              f"cost trace {np.asarray(par[dz][3].cost_trace).tolist()}", flush=True)
    cfg = _deploy(jcfg)
    prob = jtrot.make_problem(cfg, jnp.asarray(gc0), jnp.asarray(gv0), jnp.array([1.0, 0.0, 0.0]),
                              jnp.asarray(200 * cfg.control_dt), 50)
    warm = jax.jit(lambda p: jtrot.solve(cfg, jtrot.MPCConfig(horizon=50, n_iter=0),
                                         jmdl.nominal_params(cfg), p).cost)(prob)
    print(f"JAX_MPC_VS_BP5_WARM_COST = {float(warm)!r}", flush=True)
    tcfg = _deploy(tconfig.test_default())
    mc = ttrot.MPCConfig(horizon=50)
    for dz in (0.0, NUDGE_M, -NUDGE_M):
        x0 = torch.tensor(np.concatenate([gc0, gv0])[None], dtype=torch.float32)
        x0[0, 2] += dz
        prob = ttrot.make_problem(tcfg, x0[:, :19], x0[:, 19:], torch.tensor([[1.0, 0.0, 0.0]]),
                                  torch.tensor([200 * tcfg.control_dt]), 50)
        sol = ttrot.solve(tcfg, mc, tmdl.nominal_params(tcfg, "cpu"), prob)
        warm = ttrot.solve(tcfg, dataclasses.replace(mc, n_iter=0), tmdl.nominal_params(tcfg, "cpu"),
                           prob)
        print(f"port (CPU) from JAX's start, dz {dz:g}: warm start {float(warm.cost[0])!r}, cost "
              f"trace {sol.cost_trace[0].tolist()}", flush=True)


def table(n_steps: int, cmds) -> None:
    """JAX's cli/mpc.py --engine wb rows on the CPU (its chunked harness above
    1200 steps, as the CLI)."""
    jcfg = jconfig.test_default()
    for vx in cmds:
        t0 = time.time()
        env, mc = jruntime.wb_speed_schedule(jcfg, vx)
        cmd = jnp.array([vx, 0.0, 0.0])
        if n_steps > 1200:
            log = jruntime.wb_mpc_rollout_chunked(env, mc, cmd, jax.random.PRNGKey(0), n_steps,
                                                  chunk=500)
        else:
            log = jruntime.wb_mpc_rollout(env, mc, cmd, jax.random.PRNGKey(0), n_steps)
        v = float(np.asarray(jev.body_velocity(log))[int(n_steps * 0.6):, 0].mean())
        print(f"JAX CPU cmd {vx:g}: v {v!r} m/s, falls {int(np.asarray(log.done).sum())}, "
              f"solve cost ~{float(np.asarray(log.solve_cost)[-100:].mean())!r} "
              f"(T={env.period:.2f}s lam={env.lam:.2f}; {time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py refs
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py witness NMAX N[,N...]
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py parity
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py table [STEPS] [1,2,3,4,5]
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "refs":
        write_refs()
    elif sys.argv[1] == "witness":
        witness(int(sys.argv[2]), [int(n) for n in sys.argv[3].split(",")])
    elif sys.argv[1] == "parity":
        parity_witness()
    elif sys.argv[1] == "table":
        table(int(sys.argv[2]) if len(sys.argv) > 2 else 2500,
              [float(c) for c in (sys.argv[3] if len(sys.argv) > 3 else "1,2,3,4,5").split(",")])
