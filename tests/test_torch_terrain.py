"""PyTorch port: rough terrain against the JAX package.

The sampled heightmap (``phys/terrain``) bit for bit and its lookup; the plain
physics with a ground-height function (``ops/phys_lanes``) and the plain
control step on terrain against the JAX lanes physics; ``step_batch``,
``reset`` and ``env_init`` on ``configs/bp5_relax_terrain.yaml``; the
evaluation rollout of the terrain policy; and the terrain CLI paths
(``cli.train --terrain-z-curriculum``, ``cli.test --eval`` on a terrain config).

The JAX side of the two longest comparisons (3 chained control steps of
``step_batch`` and the 100-step closed loop) is XLA's lanes graph, whose CPU
compile alone takes over a minute; its outputs are read from
``tests/test_torch_terrain_refs.json``, which

    JAX_PLATFORMS=cpu python tests/test_torch_terrain.py refs

writes from the same inputs. ``... tests/test_torch_terrain.py lanes 1500``
prints the references of ``chip_smoke.py``'s terrain evaluation.

The JAX references are its lanes path (``step_batch`` with a vertical contact
normal), the path the port takes: the JAX per-env ``bp.step`` uses the
terrain's normal (``phys/contact.py``) and is printed beside them only.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as tev
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as tcli_test
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import train as tcli_train
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as tlanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as ttr
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import metrics as tmetrics
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops import phys_lanes as jlanes
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import terrain as jtr

torch.set_num_threads(1)

TORCH_CFG = "high_speed_quadrupedal_locomotion_by_irrl_torch/configs/bp5_relax_terrain.yaml"
JAX_CFG = "high_speed_quadrupedal_locomotion_by_irrl_tpu/configs/bp5_relax_terrain.yaml"
ARTIFACT = "artifacts/irrl_tpu_terrain_relaxed_r5"
REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_terrain_refs.json")
STEP_B, STEP_N = 4, 3          # step_batch: envs, chained control steps
LOOP_STEPS, TIGHT_STEPS = 100, 30
CELL = np.float32(ttr.MAP_X / 4999)


def _deploy(cfg):
    """The terrain evaluation protocol (scripts/terrain_eval_seeds.py:37-39):
    fixed commands, no noise, no domain randomization, no attacks."""
    return cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0,
                       stochastic_dynamics=False, crucial=False)


def _configs():
    return _deploy(jconfig.from_yaml(JAX_CFG)), _deploy(tconfig.from_yaml(TORCH_CFG))


def _refs() -> dict:
    with open(REFS) as f:
        return json.load(f)


def _terrain_pair(off: np.ndarray, z_scale=0.1):
    """The same batched terrain on both sides: (B, 2) offsets."""
    B = off.shape[0]
    jt = jtr.SampledTerrain(offset=jnp.asarray(off, jnp.float32), cell=jnp.full((B,), CELL),
                            z_scale=jnp.full((B,), z_scale, jnp.float32))
    return jt, ttr.at_offsets(torch.from_numpy(np.asarray(off, np.float32)), z_scale)


def _near_ground_states(B: int, seed: int, off: np.ndarray):
    """Perturbed stand states whose base stands 0.30 m above the ground under
    it (toes and some corners in contact), as (B, 19), (B, 18) float32."""
    rng = np.random.default_rng(seed)
    gc = np.tile(np.asarray(jmdl.stand_gc(0.0)), (B, 1))
    gc[:, :2] = rng.uniform(-3.0, 3.0, size=(B, 2))
    jt, _ = _terrain_pair(off)
    gc[:, 2] = 0.30 + np.asarray(jtr.height(jt, jnp.asarray(gc[:, 0], jnp.float32),
                                            jnp.asarray(gc[:, 1], jnp.float32)))
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gv = 0.5 * rng.normal(size=(B, 18))
    return gc.astype(np.float32), gv.astype(np.float32)


def _jax_lanes_params(cfg, B):
    return jlanes.params_to_lanes(jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                               jmdl.nominal_params(cfg)))


def _torch_lanes_params(cfg, B):
    return tlanes.params_to_lanes(tmdl.nominal_params(cfg, "cpu").expand(B))


# --- the heightmap --------------------------------------------------------------

def test_grid_is_the_jax_grid_bit_for_bit():
    g = ttr.fractal_grid()
    assert g.shape == (500, 5000) and g.dtype == np.float32
    np.testing.assert_array_equal(g, jtr._fractal_grid())
    t = ttr.grid(torch.device("cpu"))
    assert t.is_contiguous() and t.dtype == torch.float32 and ttr.grid(torch.device("cpu")) is t
    np.testing.assert_array_equal(t.numpy(), g)


def test_height_and_normal_match_jax():
    """4096 points against batched envs, offsets beyond both map edges so the
    clip at 0 and at n - 1.001 is taken."""
    rng = np.random.default_rng(0)
    B = 4096
    off = np.stack([rng.uniform(-10.0, 510.0, B), rng.uniform(-10.0, 60.0, B)], -1)
    x, y = (rng.uniform(-6.0, 6.0, B).astype(np.float32) for _ in range(2))
    jt, tt = _terrain_pair(off)
    want = np.asarray(jtr.height(jt, jnp.asarray(x), jnp.asarray(y)))
    got = ttr.height(tt, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    gx = (x + off[:, 0].astype(np.float32)) / CELL
    assert (gx < 0).any() and (gx > 4999).any(), "the clip edges went untested"
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the kernel's view (rows) reads the same heights
    np.testing.assert_array_equal(
        ttr.height(ttr.rows(tt), torch.from_numpy(x), torch.from_numpy(y)).numpy(), got)
    np.testing.assert_allclose(
        ttr.normal(tt, torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jtr.normal(jt, jnp.asarray(x), jnp.asarray(y))), atol=1e-4)
    assert np.abs(want).max() > 0.05
    # a flat terrain is height 0 everywhere
    assert not ttr.height(ttr.flat(B, "cpu"), torch.from_numpy(x), torch.from_numpy(y)).any()


# --- the physics ----------------------------------------------------------------------

def test_substep_with_ground_fn_matches_jax():
    """One plain lanes substep on terrain against JAX phys_lanes.substep with
    the same ground_fn (the JAX package's own test of it checks only that the
    result is finite, test_phys_lanes.py:159-174)."""
    B = 8
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(1)
    off = np.stack([rng.uniform(5.0, 495.0, B), rng.uniform(5.0, 45.0, B)], -1)
    gc, gv = _near_ground_states(B, 2, off)
    tau = (5.0 * rng.normal(size=(B, 12))).astype(np.float32)
    bw = np.concatenate([20.0 * rng.normal(size=(B, 3)), rng.normal(size=(B, 3))],
                        -1).astype(np.float32)
    jt, tt = _terrain_pair(off)
    args = (jcfg.contact_slip_vel, 0.0, jcfg.simulation_dt)
    want = jlanes.substep(_jax_lanes_params(jcfg, B),
                          *(jnp.asarray(a.T) for a in (gc, gv, tau, bw)), *args,
                          ground_fn=lambda x, y: jtr.height(jt, x, y))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    got = tlanes.substep(_torch_lanes_params(tcfg, B), t(gc), t(gv), t(tau), t(bw), *args,
                         ground_fn=lambda x, y: ttr.height(tt, x, y))
    flat = tlanes.substep(_torch_lanes_params(tcfg, B), t(gc), t(gv), t(tau), t(bw), *args)
    assert (np.asarray(want[5]) > 0).any(), "no toe in contact"
    assert not torch.equal(got[5], flat[5]), "the ground height changed no contact force"
    # the tolerances of the flat plain-vs-JAX substep test (test_torch_phys.py)
    for i, (atol, rtol) in enumerate(((1e-5, 0), (1e-3, 0), (1e-5, 0), (1e-3, 0), (5e-3, 1e-4),
                                      (5e-3, 1e-4))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=atol, rtol=rtol,
                                   err_msg=f"output {i}")


def test_plain_control_step_on_terrain_matches_jax():
    """The plain control step with a terrain against 8 x {JAX _pd_torque ->
    phys_lanes.substep with ground_fn}."""
    B = 4
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    off = np.stack([rng.uniform(5.0, 495.0, B), rng.uniform(5.0, 45.0, B)], -1)
    gc, gv = _near_ground_states(B, 4, off)
    gv[:, 6:] *= 30.0
    pt = (np.asarray(jmdl.stand_gc(0.0))[7:] + 0.3 * rng.normal(size=(B, 12))).astype(np.float32)
    tnl = (0.5 * rng.normal(size=(B, 12))).astype(np.float32)
    bw = np.zeros((B, 6), np.float32)
    jt, tt = _terrain_pair(off)
    jP = _jax_lanes_params(jcfg, B)
    gcT, gvT = jnp.asarray(gc.T), jnp.asarray(gv.T)
    imp = jcfg.contact_impulse_mass / jcfg.simulation_dt
    for _ in range(jcfg.substeps):
        tau = jbp._pd_torque(jcfg, pt, tnl, gcT[7:].T, gvT[6:].T)
        gcT, gvT, toe, toe_vel, fnorm, fn = jlanes.substep(
            jP, gcT, gvT, tau.T, jnp.asarray(bw.T), jcfg.contact_slip_vel, imp,
            jcfg.simulation_dt, ground_fn=lambda x, y: jtr.height(jt, x, y))
    want = (gcT, gvT, toe, toe_vel, fnorm, fn, tau.T)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    got = phys_cuda.control_step(_torch_lanes_params(tcfg, B), pd_torque.from_config(tcfg),
                                 t(gc), t(gv), t(pt), t(tnl), t(bw), tcfg.substeps,
                                 tcfg.contact_slip_vel, imp, tcfg.simulation_dt,
                                 terrain=ttr.rows(tt))
    assert (np.asarray(want[5]) > 0).any(), "no toe in contact"
    # the tolerances of the flat plain-control-step-vs-JAX test (test_torch_mpc.py)
    for i, (atol, rtol) in enumerate(((1e-5, 0), (1e-2, 0), (1e-5, 0), (1e-2, 0), (5e-2, 1e-3),
                                      (5e-2, 1e-3), (2e-3, 0))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=atol, rtol=rtol,
                                   err_msg=f"output {i}")


def test_zero_z_scale_is_flat_ground_bit_for_bit():
    B = 6
    _, tcfg = _configs()
    rng = np.random.default_rng(5)
    off = np.stack([rng.uniform(5.0, 495.0, B), rng.uniform(5.0, 45.0, B)], -1)
    gc, gv = _near_ground_states(B, 6, off)
    gc[:, 2] -= 0.05 * rng.uniform(size=B)   # every env near z = 0 too
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    pt = t(np.tile(tmdl.stand_gc(0.0)[7:], (B, 1)).astype(np.float32))
    args = (_torch_lanes_params(tcfg, B), pd_torque.from_config(tcfg), t(gc), t(gv), pt,
            torch.zeros(12, B), torch.zeros(6, B), 2, tcfg.contact_slip_vel, 0.0,
            tcfg.simulation_dt)
    flat = phys_cuda.control_step(*args)
    _, tt = _terrain_pair(off, z_scale=0.0)
    zero = phys_cuda.control_step(*args, terrain=ttr.rows(tt))
    assert (flat[5] > 0).any()
    for a, b in zip(flat, zero):
        assert torch.equal(a, b)


# --- the env -------------------------------------------------------------------------

def _state_from_jax(js) -> tbp.EnvState:
    """A batched JAX EnvState on terrain as the port's."""
    js = jax.tree.map(np.asarray, js)
    kw = {}
    for name in tbp.EnvState.__dataclass_fields__:
        if name == "params":
            kw[name] = tmdl.robot_params_from_numpy(js.params, "cpu")
        elif name == "terrain":
            kw[name] = ttr.SampledTerrain(*(torch.from_numpy(np.array(a)) for a in js.terrain))
        else:
            kw[name] = torch.from_numpy(np.array(getattr(js, name)))
    return tbp.EnvState(**kw)


def _step_batch_inputs(jcfg):
    """JAX env_init of STEP_B envs (each at its own map offset) with perturbed
    joints, and STEP_N sets of actions."""
    rng = np.random.default_rng(7)
    js = jax.vmap(lambda k: jbp.env_init(jcfg, k))(jax.random.split(jax.random.PRNGKey(5), STEP_B))
    js = js._replace(gc=js.gc.at[:, 7:].add(jnp.asarray(0.1 * rng.normal(size=(STEP_B, 12)),
                                                         jnp.float32)))
    actions = (0.3 * rng.normal(size=(STEP_N, STEP_B, 12))).astype(np.float32)
    return js, actions


def _rounded(x):
    """float32 values as nested lists of floats of 9 significant digits (which
    give back the same float32); booleans as they are."""
    x = np.asarray(x)
    if x.dtype == bool:
        return x.tolist()
    nine = np.vectorize(lambda v: float(f"{v:.9g}"), otypes=[object])
    return nine(x.astype(np.float32)).tolist()


def jax_step_batch_reference(jcfg) -> dict:
    """STEP_N chained JAX step_batch calls (pre, 8 lanes substeps with the
    terrain's ground_fn, post) from _step_batch_inputs."""
    js, actions = _step_batch_inputs(jcfg)
    step = jax.jit(lambda s, a: jbp.step_batch(jcfg, s, a))
    out = {k: [] for k in ("gc", "gv", "reward", "done", "obs")}
    for a in actions:
        r = step(js, jnp.asarray(a))
        js = r.state
        for k, v in (("gc", js.gc), ("gv", js.gv), ("reward", r.reward), ("done", r.done),
                     ("obs", r.obs)):
            out[k].append(_rounded(v))
    return out


def test_step_batch_on_terrain_matches_jax_lanes():
    """3 chained control steps at B = 4 on bp5_relax_terrain.yaml against JAX
    step_batch (its lanes path, blackpanther.py:813-854) from the same states,
    terrain offsets and actions."""
    jcfg, tcfg = _configs()
    js, actions = _step_batch_inputs(jcfg)
    want = _refs()["step_batch"]
    state = _state_from_jax(js)
    assert state.terrain.offset.shape == (STEP_B, 2) and (state.terrain.z_scale == 0.1).all()
    gen = torch.Generator().manual_seed(0)
    for n, a in enumerate(actions):
        out = tbp.step_batch(tcfg, state, torch.from_numpy(a), gen)
        state = out.state
        # the flat step_batch-vs-JAX tolerances (test_torch_env.py), as the states chain
        msg = f"step {n}"
        np.testing.assert_allclose(state.gc.numpy(), want["gc"][n], atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(state.gv.numpy(), want["gv"][n], atol=2e-2, err_msg=msg)
        np.testing.assert_allclose(out.obs.numpy(), want["obs"][n], atol=2e-3, err_msg=msg)
        np.testing.assert_allclose(out.reward.numpy(), want["reward"][n], atol=2e-3)
        np.testing.assert_array_equal(out.done.numpy(), want["done"][n])
    torch.testing.assert_close(state.terrain.offset, torch.from_numpy(np.array(js.terrain.offset)),
                               atol=0, rtol=0)


def test_reset_spawns_above_the_ground_as_jax():
    """The training config (random xy): JAX reset's spawn height equals the
    stand height plus the port's ground height at JAX's xy, and the port's
    reset spawns the same way at its own xy."""
    jcfg = jconfig.from_yaml(JAX_CFG)
    tcfg = tconfig.from_yaml(TORCH_CFG)
    B = 8
    js = jax.vmap(lambda k: jbp.env_init(jcfg, k))(jax.random.split(jax.random.PRNGKey(2), B))
    ts = _state_from_jax(js)
    jgc = np.array(js.gc)
    stand_z = np.float32(tmdl.stand_gc(tcfg.abad)[2])
    h = ttr.height(ts.terrain, torch.from_numpy(jgc[:, 0]), torch.from_numpy(jgc[:, 1])).numpy()
    assert np.abs(h).max() > 0.01
    np.testing.assert_allclose(jgc[:, 2], stand_z + h, atol=1e-6, rtol=0)
    got = tbp.reset(tcfg, ts, torch.Generator().manual_seed(1))
    assert torch.equal(got.terrain.offset, ts.terrain.offset)
    h2 = ttr.height(ts.terrain, got.gc[:, 0], got.gc[:, 1])
    torch.testing.assert_close(got.gc[:, 2], stand_z + h2, atol=0, rtol=0)


def test_env_init_keeps_offsets_in_the_jax_range():
    """Per-env offsets drawn from the caller's generator lie within 40 % of the
    map extent around its centre (JAX terrain.py:110-118), as JAX's do."""
    B = 256
    tcfg = tconfig.from_yaml(TORCH_CFG).replace(stochastic_dynamics=False)
    s = tbp.env_init(tcfg, B, torch.Generator().manual_seed(0), "cpu")
    jo = np.asarray(jax.vmap(lambda k: jtr.sampled_fractal(k, 0.1).offset)(
        jax.random.split(jax.random.PRNGKey(0), B)))
    cell = ttr.MAP_X / 4999
    center = np.array([4999 * cell / 2, 499 * cell / 2])
    lim = np.array([4999 * cell * 0.4, 499 * cell * 0.4])
    for off in (s.terrain.offset.numpy(), jo):
        assert (np.abs(off - center) <= lim * (1 + 1e-6)).all()
        assert (np.abs(off - center) > 0.8 * lim).any(axis=0).all()   # spread over the range
    np.testing.assert_array_equal(s.terrain.cell.numpy(), np.full(B, CELL))
    np.testing.assert_array_equal(s.terrain.z_scale.numpy(), np.full(B, np.float32(0.1)))
    # the analytic fractal draws seeds in JAX's range, [0, 1000) (JAX terrain.py:37-39)
    a = tbp.env_init(tcfg.replace(terrain_sampled=False), B, torch.Generator().manual_seed(0),
                     "cpu")
    js = np.asarray(jax.vmap(lambda k: jtr.fractal(k, 0.1).seed)(
        jax.random.split(jax.random.PRNGKey(0), B)))
    for seed in (a.terrain.seed.numpy(), js):
        assert seed.min() >= 0.0 and seed.max() < 1000.0 and seed.max() - seed.min() > 900.0
    np.testing.assert_array_equal(a.terrain.z_scale.numpy(), np.full(B, np.float32(0.1)))


# --- the evaluation slice -------------------------------------------------------------

def jax_offset(k: int, z_scale: float = 0.1) -> np.ndarray:
    """The map offset JAX env_init(cfg, PRNGKey(k)) gives its env
    (blackpanther.py:424-430)."""
    k_tr = jax.random.split(jax.random.PRNGKey(k), 3)[1]
    return np.asarray(jtr.sampled_fractal(k_tr, z_scale).offset)


def jax_lanes_rollout(cmds: np.ndarray, keys: list, n_steps: int, params=None) -> dict:
    """JAX eval.policy_rollout of the terrain policy with its env stepped
    through step_batch (the lanes physics with the terrain's ground_fn, the
    port's path) for a batch: env b at command cmds[b] from
    env_init(cfg, PRNGKey(keys[b])). -> gc, gv (T, B, .) and done (T, B)."""
    jcfg, _ = _configs()
    params = jio.load_bp5_csv(ARTIFACT) if params is None else params
    B = len(keys)
    cmd = jnp.asarray(cmds, jnp.float32)
    states = jax.vmap(lambda k: jbp.env_init(jcfg, k))(
        jnp.stack([jax.random.PRNGKey(k) for k in keys]))
    states = states._replace(command=cmd, command_filtered=cmd)
    obs0 = jax.vmap(lambda s: jbp.observe(jcfg, s))(states)
    cmd_n = (cmd - jbp.obs_mean(jcfg)[:3]) / jbp.obs_std(jcfg)[:3]
    s_size = jlstm.state_size([w.wh.shape[0] for w in params.pi_lstm])

    def scan_fn(carry, _):
        states, lstm_state, obs = carry
        delayed = obs.at[:, :3].set(cmd_n)   # manual-mode command injection
        action, lstm_state = jlstm.deterministic_action(params, delayed, lstm_state,
                                                        jnp.zeros((B,)))
        out = jbp.step_batch(jcfg, states._replace(command=cmd, command_filtered=cmd), action)
        return (out.state, lstm_state, out.obs), (out.state.gc, out.state.gv, out.done)

    run = jax.jit(lambda s, o: jax.lax.scan(scan_fn, (s, jnp.zeros((B, s_size)), o), None,
                                            length=n_steps)[1])
    gc, gv, done = run(states, obs0)
    return {"gc": np.asarray(gc), "gv": np.asarray(gv), "done": np.asarray(done)}


def test_eval_rollout_on_terrain_matches_jax_lanes():
    """The terrain policy in closed loop at cmd 1 on JAX's map offset of
    PRNGKey(0), on the port's plain path, against the JAX lanes loop."""
    _, tcfg = _configs()
    want = np.asarray(_refs()["eval_gc"])
    off = jax_offset(0)
    np.testing.assert_allclose(off, _refs()["eval_offset"], atol=0)
    got = tev.policy_rollout(tcfg, tio.load_bp5_csv(ARTIFACT, device="cpu"),
                             np.array([1.0, 0.0, 0.0], np.float32), torch.Generator(), LOOP_STEPS,
                             device="cpu", terrain_offset=torch.tensor(off[None]))
    gc = got.gc.numpy()
    assert gc.shape == want.shape == (LOOP_STEPS, 19) and not got.done.any()
    # first 30 steps: rounding (the flat loop's bound, test_torch_mpc.py); all 100:
    # the two physics drift apart after touchdowns
    np.testing.assert_allclose(gc[:TIGHT_STEPS], want[:TIGHT_STEPS], atol=2e-6)
    np.testing.assert_allclose(gc, want, atol=2e-3)
    assert gc[-1, 0] < gc[0, 0] - 0.02, "the robot did not walk (WILDCAT: forward is -x)"


# --- the entry points ------------------------------------------------------------------

def test_cli_train_terrain_z_curriculum(tmp_path, capsys):
    """z_scale ramps LO -> HI between updates (set before each), as JAX
    cli/train.py:195-208; the checkpoint records it, and cli.test evaluates
    the run's checkpoint on the terrain config."""
    run = tcli_train.main(["--cfg", TORCH_CFG, "--device", "cpu", "--num-envs", "4",
                           "--n-steps", "8", "--max-updates", "2", "--log-dir", str(tmp_path),
                           "--terrain-z-curriculum", "0.03,0.07"])
    rows = tmetrics.read_jsonl(os.path.join(run, "metrics.jsonl"))
    np.testing.assert_allclose([r["terrain_z_scale"] for r in rows], [0.03, 0.07], rtol=1e-6)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    ckpt = os.path.join(run, "ckpt_final.pkl")
    with open(ckpt, "rb") as f:
        blob = tio._NumpyOnlyUnpickler(f).load()
    assert blob["terrain_z_scale"] == pytest.approx(0.07) and blob["step"] == 2
    res = tcli_test.main(["--model", ckpt, "--cfg", TORCH_CFG, "--eval", "--commands", "1",
                          "--steps", "3", "--device", "cpu"])
    assert len(res["tracking"]) == 1 and np.isfinite(res["tracking"][0]["v_mean"])
    assert "cmd 1.0 m/s -> v " in capsys.readouterr().out


def test_cli_test_eval_on_a_terrain_config(capsys):
    res = tcli_test.main(["--model", ARTIFACT, "--cfg", TORCH_CFG, "--eval", "--commands",
                          "1,3", "--steps", "4", "--device", "cpu"])
    rows = res["tracking"]
    assert [r["command"] for r in rows] == [1.0, 3.0] and all(r["falls"] == 0 for r in rows)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("cmd ")]
    assert len(lines) == 2 and lines[1].startswith("cmd 3.0 m/s -> v ")


def test_one_offset_per_command_set_unless_given(monkeypatch):
    """Every env of an evaluation batch starts on the same stretch of map (JAX
    rolls every command from one key), unless offsets are given."""
    _, tcfg = _configs()
    params = tio.load_bp5_csv(ARTIFACT, device="cpu")
    cmds = np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0]], np.float32)
    seen = []
    real = tbp.env_init

    def spy(*a, **kw):
        s = real(*a, **kw)
        seen.append(s.terrain.offset.clone())
        return s
    monkeypatch.setattr(tbp, "env_init", spy)
    tev.policy_rollout(tcfg, params, cmds, torch.Generator().manual_seed(0), 1, device="cpu")
    given = torch.tensor([[100.0, 20.0], [300.0, 30.0]])
    tev.policy_rollout(tcfg, params, cmds, torch.Generator(), 1, device="cpu",
                       terrain_offset=given)
    assert torch.equal(seen[0][0], seen[0][1]) and torch.equal(seen[1], given)
    with pytest.raises(ValueError, match="without terrain"):
        real(tconfig.test_default(), 2, torch.Generator(), "cpu", given)


# --- references (script mode) ----------------------------------------------------------

def terrain_eval_reference(n_steps: int, K: int = 8, commands=(1.0, 2.0, 3.0)) -> None:
    """What chip_smoke.py's terrain evaluation holds the port to: the terrain
    policy at each command from env_init(cfg, PRNGKey(k)), k < K (the seed
    ensemble of scripts/terrain_eval_seeds.py), all K x len(commands) rollouts
    as one batch of the JAX lanes loop. Prints the K offsets; per command the
    trailing-40 % forward speed of each rollout (signed as tracking_eval signs
    it) and the falls; the base coordinates (7) of each rollout after 50 and
    100 control steps; and, ungated, the JAX per-env loop's speeds."""
    jcfg, _ = _configs()
    params = jio.load_bp5_csv(ARTIFACT)
    sign = -1.0 if jcfg.wildcat else 1.0
    skip = int(n_steps * 0.6)
    keys = [k for _ in commands for k in range(K)]
    cmds = np.array([[vx, 0.0, 0.0] for vx in commands for _ in range(K)], np.float32)
    log = jax_lanes_rollout(cmds, keys, n_steps, params)
    vb = np.asarray(jev.body_velocity(SimpleNamespace(
        gc=log["gc"].reshape(-1, 19), gv=log["gv"].reshape(-1, 18)))).reshape(n_steps, -1, 3)
    v = sign * vb[skip:, :, 0].mean(axis=0)
    falls = log["done"].sum(axis=0)
    print("JAX_TERRAIN_OFFSETS =", [[float(a) for a in jax_offset(k)] for k in range(K)])
    print("JAX_TERRAIN_LANES =", {vx: ([float(x) for x in v[i * K:(i + 1) * K]],
                                       int(falls[i * K:(i + 1) * K].sum()))
                                  for i, vx in enumerate(commands)})
    print("JAX_TERRAIN_BASE =", [[[[float(f"{x:.9g}") for x in log["gc"][s - 1, b, :7]]
                                   for s in (50, 100)] for b in range(i * K, (i + 1) * K)]
                                 for i in range(len(commands))])
    for i, vx in enumerate(commands):
        vs, nf = [], 0
        for k in range(K):
            r = jev.policy_rollout(jcfg, params, jnp.array([vx, 0.0, 0.0]),
                                   jax.random.PRNGKey(k), n_steps)
            vs.append(float(sign * np.asarray(jev.body_velocity(r))[skip:, 0].mean()))
            nf += int(np.asarray(r.done).sum())
        print(f"JAX per-env loop (terrain normal), cmd {vx}: mean {np.mean(vs):.4f} +- "
              f"{np.std(vs):.4f} (lanes {v[i * K:(i + 1) * K].mean():.4f}), falls {nf}; "
              f"by offset {[round(x, 4) for x in vs]}", flush=True)


def write_refs() -> None:
    """tests/test_torch_terrain_refs.json: the JAX sides of
    test_step_batch_on_terrain_matches_jax_lanes and
    test_eval_rollout_on_terrain_matches_jax_lanes."""
    jcfg, _ = _configs()
    off = jax_offset(0)
    loop = jax_lanes_rollout(np.array([[1.0, 0.0, 0.0]], np.float32), [0], LOOP_STEPS)
    refs = {"step_batch": jax_step_batch_reference(jcfg),
            "eval_offset": [float(a) for a in off],
            "eval_gc": _rounded(loop["gc"][:, 0])}
    with open(REFS, "w") as f:
        json.dump(refs, f, separators=(",", ":"))
    print(f"wrote {REFS}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_terrain.py refs
    # JAX_PLATFORMS=cpu python tests/test_torch_terrain.py lanes 1500
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "refs":
        write_refs()
    elif sys.argv[1] == "lanes":
        terrain_eval_reference(int(sys.argv[2]))
