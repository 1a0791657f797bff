"""PyTorch port: the analytic fractal terrain (``cfg.terrain_sampled=False``)
against the JAX package.

The terrain's hash ``fract(sin(.) * 43758.5453)`` turns a one-ulp difference
between two float32 ``sin`` implementations into a jump of the height (up to
0.2 m, at well under 1 % of points), so the port's ``height`` and ``normal``
are held to JAX's by statistics over a cloud of points, with limits fixed
from measurement: p99 |dh| <= 1e-3 m with at most 1 % of points beyond it and
the height's spread within 2 % (a float64 implementation, another terrain,
must fail the same gate); p99 |dn| <= 5e-3 with at most 1 % beyond 1e-2.
Then the plain control step on it against 8 x {JAX PD torque + lanes
substep}, ``reset``'s spawn height, and 50 closed-loop steps of the terrain
policy (the toes land at step ~35) through ``step_batch`` (the lanes
physics, vertical normal) and the per-env ``step`` (the terrain's own
normal) against JAX's, from JAX's ``env_init`` seeds: bases within 2e-3.

The JAX side of the two closed loops is read from
``tests/test_torch_terrain_analytic_refs.json``, which

    JAX_PLATFORMS=cpu python tests/test_torch_terrain_analytic.py refs

writes (JAX's lanes graph takes minutes to compile on the CPU);
``... tests/test_torch_terrain_analytic.py lanes 1500`` prints the
references of ``chip_smoke.py`` phase 17b (the JAX lanes loop of 24 envs,
and again from a start 1e-6 m higher and lower).
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
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as tlanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as ttr
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
REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "test_torch_terrain_analytic_refs.json")
GATE_SEEDS = (3.7, 512.3, 999.1)
H_P99, H_FRAC, STD_RTOL = 1e-3, 0.01, 0.02          # the height gate
N_P99, N_FRAC_AT, N_FRAC = 5e-3, 1e-2, 0.01         # the normal gate
LOOP_CMDS, LOOP_KEYS, LOOP_STEPS = (1.0, 2.0, 3.0), (0, 1, 2), 50
BASE_ATOL = 2e-3        # phase 10's base limit, at every step to 50 (the toes land at ~35)


def _cloud(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-5.0, 60.0, n).astype(np.float32),
            rng.uniform(-10.0, 10.0, n).astype(np.float32))


def _jax_height(seed: float, x, y) -> np.ndarray:
    jt = jtr.TerrainParams(z_scale=jnp.float32(0.1), seed=jnp.float32(seed))
    return np.asarray(jax.jit(jtr.height)(jt, jnp.asarray(x), jnp.asarray(y)))


def _height_gate(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got.astype(np.float64) - want)
    return {"p99": float(np.percentile(d, 99)), "frac": float((d > H_P99).mean()),
            "std_rel": float(abs(got.std() - want.std()) / want.std())}


def _passes(g: dict) -> bool:
    return g["p99"] <= H_P99 and g["frac"] <= H_FRAC and g["std_rel"] <= STD_RTOL


@pytest.mark.parametrize("seed", GATE_SEEDS)
def test_height_passes_the_statistical_gate(seed):
    """200,000 points over x in [-5, 60] m, y in [-10, 10] m at z_scale 0.1."""
    x, y = _cloud(200_000)
    want = _jax_height(seed, x, y)
    got = ttr.height(ttr.with_seeds(torch.full((x.size,), seed), 0.1), torch.from_numpy(x),
                     torch.from_numpy(y)).numpy()
    g = _height_gate(got, want)
    assert _passes(g), g
    assert (got == want).mean() > 0.2, "the port's float32 order is not JAX's"


def test_a_float64_terrain_fails_the_gate():
    """The hash in float64 is another terrain: the gate must tell it apart."""
    x, y = _cloud(200_000)
    for seed in GATE_SEEDS:
        f64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
        got = ttr.analytic_height(f64(seed), f64(0.1), f64(x), f64(y)).numpy()
        g = _height_gate(got, _jax_height(seed, x, y))
        assert not _passes(g), g
        assert g["frac"] > 0.9


@pytest.mark.parametrize("seed", GATE_SEEDS)
def test_normal_passes_the_statistical_gate(seed):
    x, y = _cloud(50_000, 1)
    jt = jtr.TerrainParams(z_scale=jnp.float32(0.1), seed=jnp.float32(seed))
    want = np.asarray(jax.jit(jtr.normal)(jt, jnp.asarray(x), jnp.asarray(y)))
    got = ttr.normal(ttr.with_seeds(torch.full((x.size,), seed), 0.1), torch.from_numpy(x),
                     torch.from_numpy(y)).numpy()
    d = np.abs(got - want).max(axis=-1)
    assert np.percentile(d, 99) <= N_P99 and (d > N_FRAC_AT).mean() <= N_FRAC
    assert np.abs(want[:, :2]).max() > 0.1, "a flat cloud tests no slope"


def test_fractal_draws_seeds_and_flat_is_zero():
    tp = ttr.fractal(torch.Generator().manual_seed(0), 4096, 0.1, "cpu")
    assert tp.seed.shape == (4096,) and tp.seed.dtype == torch.float32
    assert 0.0 <= tp.seed.min() and tp.seed.max() < 1000.0 and tp.seed.std() > 250.0
    assert (tp.z_scale == np.float32(0.1)).all()
    x, y = (torch.from_numpy(a) for a in _cloud(4096))
    assert not ttr.height(ttr.with_seeds(tp.seed, 0.0), x, y).any()
    # (B, k) points against (B,) envs read each env's own terrain
    pts = ttr.height(tp, x[:, None].expand(4096, 3), y[:, None].expand(4096, 3))
    torch.testing.assert_close(pts[:, 1], ttr.height(tp, x, y), atol=0, rtol=0)
    assert ttr.rows(tp).seed.is_contiguous()


# --- the physics ------------------------------------------------------------------

def _configs(sampled: bool = False, deploy: bool = True):
    def prep(cfg):
        cfg = cfg.replace(terrain_sampled=sampled)
        if deploy:   # scripts/terrain_eval_seeds.py:37-39: no noise, no DR, no attacks
            cfg = cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0,
                              stochastic_dynamics=False, crucial=False)
        return cfg
    return prep(jconfig.from_yaml(JAX_CFG)), prep(tconfig.from_yaml(TORCH_CFG))


def jax_seed(k: int, z_scale: float = 0.1) -> float:
    """The seed JAX env_init(cfg, PRNGKey(k)) draws for its analytic terrain
    (blackpanther.py:424-432)."""
    k_tr = jax.random.split(jax.random.PRNGKey(k), 3)[1]
    return float(jtr.fractal(k_tr, z_scale).seed)


def test_plain_control_step_on_analytic_terrain_matches_jax():
    """The plain control step with analytic terrain rows against 8 x {JAX
    _pd_torque -> phys_lanes.substep with the analytic ground_fn}."""
    B = 4
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    seeds = rng.uniform(0.0, 1000.0, B).astype(np.float32)
    jt = jtr.TerrainParams(z_scale=jnp.full((B,), 0.1, jnp.float32), seed=jnp.asarray(seeds))
    gc = np.tile(np.asarray(jmdl.stand_gc(0.0)), (B, 1))
    gc[:, :2] = rng.uniform(-3.0, 3.0, size=(B, 2))
    gc[:, 2] = 0.30 + np.asarray(jtr.height(jt, jnp.asarray(gc[:, 0], jnp.float32),
                                            jnp.asarray(gc[:, 1], jnp.float32)))
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gc, gv = gc.astype(np.float32), (0.5 * rng.normal(size=(B, 18))).astype(np.float32)
    gv[:, 6:] *= 30.0
    pt = (np.asarray(jmdl.stand_gc(0.0))[7:] + 0.3 * rng.normal(size=(B, 12))).astype(np.float32)
    tnl = (0.5 * rng.normal(size=(B, 12))).astype(np.float32)
    bw = np.zeros((B, 6), np.float32)
    jP = jlanes.params_to_lanes(jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                             jmdl.nominal_params(jcfg)))
    gcT, gvT = jnp.asarray(gc.T), jnp.asarray(gv.T)
    imp = jcfg.contact_impulse_mass / jcfg.simulation_dt
    for _ in range(jcfg.substeps):
        tau = jbp._pd_torque(jcfg, pt, tnl, gcT[7:].T, gvT[6:].T)
        gcT, gvT, toe, toe_vel, fnorm, fn = jlanes.substep(
            jP, gcT, gvT, tau.T, jnp.asarray(bw.T), jcfg.contact_slip_vel, imp,
            jcfg.simulation_dt, ground_fn=lambda x, y: jtr.height(jt, x, y))
    want = (gcT, gvT, toe, toe_vel, fnorm, fn, tau.T)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    tp = ttr.rows(ttr.with_seeds(torch.from_numpy(seeds), 0.1))
    got = phys_cuda.control_step(tlanes.params_to_lanes(tmdl.nominal_params(tcfg, "cpu").expand(B)),
                                 pd_torque.from_config(tcfg), t(gc), t(gv), t(pt), t(tnl), t(bw),
                                 tcfg.substeps, tcfg.contact_slip_vel, imp, tcfg.simulation_dt,
                                 terrain=tp)
    assert (np.asarray(want[5]) > 0).any(), "no toe in contact"
    # the tolerances of the sampled-terrain test (test_torch_terrain.py), but the
    # last substep's torque at gv's 1e-2 (tau = kp dq - kd qd, kd = 1): the hash's
    # last-bit differences move the contact forces more than bilinear rounding does
    for i, (atol, rtol) in enumerate(((1e-5, 0), (1e-2, 0), (1e-5, 0), (1e-2, 0), (5e-2, 1e-3),
                                      (5e-2, 1e-3), (1e-2, 0))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=atol, rtol=rtol,
                                   err_msg=f"output {i}")


def test_smoke_bound_counts_the_analytic_lookups():
    """chip_smoke.py's operations bound of the analytic instantiation: 12
    lookups an env a substep of ANALYTIC_LOOKUP_OPS each, under what the
    plain version does with the analytic ground_fn."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    B = 2
    P = tlanes.params_to_lanes(tmdl.nominal_params(None, "cpu").expand(B))
    gc = torch.from_numpy(np.tile(tmdl.stand_gc(), (B, 1)).T.astype(np.float32).copy())
    tp = ttr.with_seeds(torch.tensor([7.3, 403.6]), 0.1)
    args = (P, gc, torch.zeros(18, B), torch.zeros(12, B), torch.zeros(6, B), 0.1, 0.0, 2.5e-4)
    plain = chip_smoke.count_ops(lambda: tlanes.substep(*args)) / B
    plain_a = chip_smoke.count_ops(lambda: tlanes.substep(
        *args, ground_fn=lambda x, y: ttr.height(tp, x, y))) / B
    need = chip_smoke.phys_ops_per_env(1, pd_law=False)
    need_a = chip_smoke.phys_ops_per_env(1, pd_law=False, terrain=True, analytic=True)
    assert need_a - need == 12 * chip_smoke.ANALYTIC_LOOKUP_OPS
    assert 0.25 * plain_a < need_a < 0.5 * plain_a and plain_a - plain > need_a - need


def _state_from_jax(js) -> tbp.EnvState:
    """A batched JAX EnvState on the analytic terrain as the port's."""
    js = jax.tree.map(np.asarray, js)
    kw = {}
    for name in tbp.EnvState.__dataclass_fields__:
        if name == "params":
            kw[name] = tmdl.robot_params_from_numpy(js.params, "cpu")
        elif name == "terrain":
            kw[name] = ttr.TerrainParams(*(torch.from_numpy(np.array(a)) for a in js.terrain))
        else:
            kw[name] = torch.from_numpy(np.array(getattr(js, name)))
    return tbp.EnvState(**kw)


def test_env_init_and_reset_spawn_on_the_analytic_ground_as_jax():
    """The training config (random xy): JAX reset's spawn height is the stand
    height plus the port's ground at JAX's xy and seed (within 1e-3 m: the
    hash), and the port's own env_init and reset spawn the same way."""
    jcfg, tcfg = _configs(deploy=False)
    B = 16
    js = jax.vmap(lambda k: jbp.env_init(jcfg, k))(jax.random.split(jax.random.PRNGKey(2), B))
    ts = _state_from_jax(js)
    assert isinstance(ts.terrain, ttr.TerrainParams) and ts.terrain.seed.shape == (B,)
    jgc = np.array(js.gc)
    stand_z = np.float32(tmdl.stand_gc(tcfg.abad)[2])
    h = ttr.height(ts.terrain, torch.from_numpy(jgc[:, 0]), torch.from_numpy(jgc[:, 1])).numpy()
    assert np.abs(h).max() > 0.01
    np.testing.assert_allclose(jgc[:, 2], stand_z + h, atol=1e-3, rtol=0)
    got = tbp.reset(tcfg, ts, torch.Generator().manual_seed(1))
    assert torch.equal(got.terrain.seed, ts.terrain.seed)
    torch.testing.assert_close(got.gc[:, 2], stand_z + ttr.height(ts.terrain, got.gc[:, 0],
                                                                  got.gc[:, 1]), atol=0, rtol=0)
    own = tbp.env_init(tcfg, B, torch.Generator().manual_seed(3), "cpu")
    assert isinstance(own.terrain, ttr.TerrainParams)
    assert 0.0 <= own.terrain.seed.min() and own.terrain.seed.max() < 1000.0
    torch.testing.assert_close(own.gc[:, 2], stand_z + ttr.height(own.terrain, own.gc[:, 0],
                                                                  own.gc[:, 1]), atol=0, rtol=0)
    seeds = torch.arange(B, dtype=torch.float32) * 61.0
    given = tbp.env_init(tcfg, B, torch.Generator(), "cpu", terrain_seed=seeds)
    assert torch.equal(given.terrain.seed, seeds)
    with pytest.raises(ValueError, match="terrain_offset given for the analytic terrain"):
        tbp.env_init(tcfg, 2, torch.Generator(), "cpu", terrain_offset=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="terrain_seed given for the sampled heightmap"):
        tbp.env_init(tcfg.replace(terrain_sampled=True), 2, torch.Generator(), "cpu",
                     terrain_seed=seeds[:2])


def test_one_seed_per_command_set_unless_given(monkeypatch):
    """As on the heightmap: every env of an evaluation batch stands on the same
    terrain (JAX rolls every command from one key), unless seeds are given."""
    _, tcfg = _configs()
    params = tio.load_bp5_csv(ARTIFACT, device="cpu")
    cmds = np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0]], np.float32)
    seen = []
    real = tbp.env_init

    def spy(*a, **kw):
        s = real(*a, **kw)
        seen.append(s.terrain.seed.clone())
        return s
    monkeypatch.setattr(tbp, "env_init", spy)
    tev.policy_rollout(tcfg, params, cmds, torch.Generator().manual_seed(0), 1, device="cpu")
    given = torch.tensor([100.0, 300.0])
    tev.policy_rollout(tcfg, params, cmds, torch.Generator(), 1, device="cpu",
                       terrain_seed=given)
    assert seen[0][0] == seen[0][1] and torch.equal(seen[1], given)


# --- the closed loops ------------------------------------------------------------------

def jax_loop(cmds, keys, n_steps: int, lanes: bool, dz: float = 0.0, params=None) -> dict:
    """The terrain policy in closed loop on JAX, env b at cmds[b] from
    env_init(cfg, PRNGKey(keys[b])) (base raised by ``dz``), stepped through
    step_batch (the lanes physics, the port's path) or vmap(step) (the
    per-env physics). -> gc (T, B, 19), gv (T, B, 18), done (T, B)."""
    jcfg, _ = _configs()
    params = jio.load_bp5_csv(ARTIFACT) if params is None else params
    B = len(keys)
    cmd = jnp.asarray(cmds, jnp.float32)
    states = jax.vmap(lambda k: jbp.env_init(jcfg, k))(
        jnp.stack([jax.random.PRNGKey(k) for k in keys]))
    states = states._replace(command=cmd, command_filtered=cmd, gc=states.gc.at[:, 2].add(dz))
    obs0 = jax.vmap(lambda s: jbp.observe(jcfg, s))(states)
    cmd_n = (cmd - jbp.obs_mean(jcfg)[:3]) / jbp.obs_std(jcfg)[:3]
    s_size = jlstm.state_size([w.wh.shape[0] for w in params.pi_lstm])
    step = ((lambda s, a: jbp.step_batch(jcfg, s, a)) if lanes
            else jax.vmap(lambda s, a: jbp.step(jcfg, s, a)))

    def scan_fn(carry, _):
        states, lstm_state, obs = carry
        delayed = obs.at[:, :3].set(cmd_n)   # manual-mode command injection
        action, lstm_state = jlstm.deterministic_action(params, delayed, lstm_state,
                                                        jnp.zeros((B,)))
        out = step(states._replace(command=cmd, command_filtered=cmd), action)
        return (out.state, lstm_state, out.obs), (out.state.gc, out.state.gv, out.done)

    run = jax.jit(lambda s, o: jax.lax.scan(scan_fn, (s, jnp.zeros((B, s_size)), o), None,
                                            length=n_steps)[1])
    gc, gv, done = run(states, obs0)
    return {"gc": np.asarray(gc), "gv": np.asarray(gv), "done": np.asarray(done)}


def _port_loop(step_fn, n_steps: int) -> torch.Tensor:
    """The port's side of jax_loop at LOOP_CMDS from JAX's seeds of LOOP_KEYS,
    stepped by ``step_fn``. -> gc (T, B, 19)."""
    _, tcfg = _configs()
    params = tio.load_bp5_csv(ARTIFACT, device="cpu")
    cmd = torch.tensor([[vx, 0.0, 0.0] for vx in LOOP_CMDS])
    seeds = torch.tensor([jax_seed(k) for k in LOOP_KEYS])
    gen = torch.Generator().manual_seed(0)
    state = tbp.env_init(tcfg, len(LOOP_KEYS), gen, "cpu", terrain_seed=seeds)
    state = state.replace(command=cmd, command_filtered=cmd)
    obs = tbp.observe(tcfg, state)
    cmd_n = (cmd - tbp.obs_mean(tcfg, "cpu")[:3]) / tbp.obs_std(tcfg, "cpu")[:3]
    lstm_state = torch.zeros((len(LOOP_KEYS), tlstm.state_size([48, 48])))
    gcs = []
    for _ in range(n_steps):
        action, lstm_state = tlstm.deterministic_action(
            params, torch.cat([cmd_n, obs[:, 3:]], -1), lstm_state, torch.zeros(len(LOOP_KEYS)))
        out = step_fn(tcfg, state.replace(command=cmd, command_filtered=cmd), action, gen)
        state, obs = out.state, out.obs
        assert not out.done.any()
        gcs.append(state.gc)
    return torch.stack(gcs)


def _refs() -> dict:
    with open(REFS) as f:
        return json.load(f)


@pytest.mark.parametrize("path", ["step_batch", "step"])
def test_closed_loop_on_analytic_terrain_matches_jax(path):
    """50 steps of the terrain policy at cmd 1-3, each env on its JAX seed:
    the plain step_batch against JAX's lanes loop, the per-env step against
    JAX's vmap(step) loop; bases (position and orientation) within 2e-3."""
    refs = _refs()
    np.testing.assert_array_equal(refs["seeds"], [np.float32(jax_seed(k)) for k in LOOP_KEYS])
    got = _port_loop(getattr(tbp, path), LOOP_STEPS).numpy()
    want = np.asarray(refs[path])
    assert got.shape == want.shape == (LOOP_STEPS, len(LOOP_KEYS), 19)
    np.testing.assert_allclose(got[..., :7], want[..., :7], atol=BASE_ATOL, rtol=0)
    stand = np.float32(tmdl.stand_gc(0.0)[2])
    assert np.abs(want[0, :, 2] - stand).max() > 5e-3, "the robots stand on flat ground"
    assert np.abs(want[-1, :, :3] - want[0, :, :3]).max() > 1e-3, "the bases did not move"


# --- references (script mode) ----------------------------------------------------------

def _rounded(x):
    nine = np.vectorize(lambda v: float(f"{v:.9g}"), otypes=[object])
    return nine(np.asarray(x, np.float32)).tolist()


def write_refs() -> None:
    cmds = np.array([[vx, 0.0, 0.0] for vx in LOOP_CMDS], np.float32)
    refs = {"seeds": [float(np.float32(jax_seed(k))) for k in LOOP_KEYS]}
    for path, lanes in (("step_batch", True), ("step", False)):
        refs[path] = _rounded(jax_loop(cmds, list(LOOP_KEYS), LOOP_STEPS, lanes)["gc"])
    with open(REFS, "w") as f:
        json.dump(refs, f, separators=(",", ":"))
    print(f"wrote {REFS}")


def closed_loop_reference(n_steps: int, K: int = 8, commands=(1.0, 2.0, 3.0)) -> None:
    """chip_smoke.py phase 17b's constants: the terrain policy at each command
    from env_init(cfg, PRNGKey(k)), k < K, all K x len(commands) rollouts as
    one batch of the JAX lanes loop, and again from a start 1e-6 m higher and
    lower. Prints the K seeds, per command the trailing-40 % forward speed of
    each rollout (signed as tracking_eval signs it) and the falls of each run,
    and the spread of the mean speed under the nudge."""
    jcfg, _ = _configs()
    params = jio.load_bp5_csv(ARTIFACT)
    sign = -1.0 if jcfg.wildcat else 1.0
    skip = int(n_steps * 0.6)
    keys = [k for _ in commands for k in range(K)]
    cmds = np.array([[vx, 0.0, 0.0] for vx in commands for _ in range(K)], np.float32)
    runs = {}
    for dz in (0.0, 1e-6, -1e-6):
        log = jax_loop(cmds, keys, n_steps, True, dz, params)
        T, B = log["gc"].shape[:2]
        vb = np.asarray(jev.body_velocity(SimpleNamespace(
            gc=log["gc"].reshape(-1, 19), gv=log["gv"].reshape(-1, 18)))).reshape(T, B, 3)
        v = sign * vb[skip:, :, 0].mean(axis=0)
        falls = log["done"].sum(axis=0)
        runs[dz] = {vx: ([float(x) for x in v[i * K:(i + 1) * K]],
                         int(falls[i * K:(i + 1) * K].sum())) for i, vx in enumerate(commands)}
        print(f"dz {dz:+g}:", runs[dz], flush=True)
    print("JAX_ANALYTIC_SEEDS =", [float(np.float32(jax_seed(k))) for k in range(K)])
    print("JAX_ANALYTIC_LANES =", runs[0.0])
    print("JAX_ANALYTIC_NUDGE =", {vx: {"spread": max(abs(np.mean(runs[dz][vx][0])
                                                          - np.mean(runs[0.0][vx][0]))
                                                      for dz in (1e-6, -1e-6)),
                                        "falls": [runs[dz][vx][1] for dz in runs]}
                                   for vx in commands})


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_terrain_analytic.py refs
    # JAX_PLATFORMS=cpu python tests/test_torch_terrain_analytic.py lanes 1500
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "refs":
        write_refs()
    elif sys.argv[1] == "lanes":
        closed_loop_reference(int(sys.argv[2]))
