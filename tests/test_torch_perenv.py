"""PyTorch port: the per-env control step against the JAX package.

``envs.blackpanther.step`` (the port's counterpart of JAX ``vmap(bp.step)``)
and what it stands on: the hard-contact impulse solve
(``phys/hard_contact``), the attack spheres' contact (``_sphere_robot_forces``)
and the introspection getters; then the paths that choose it: the PPO
rollout (``use_lanes_physics``) and the evaluation rollout under hard
contact or attacks. Inputs come from numpy with a seed, or from JAX's
``env_init`` carried over, under configs whose random draws do not reach
the result. Everything runs on the CPU at a few envs.

Run as a script, the file prints what the chip smoke's phase 15 holds the
port to and how far the per-env loop may part from JAX over longer horizons:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_perenv.py refs N
        JAX's analysis.eval of the flagship at cmd 1-5 for N steps under hard
        contact and under the attacks: the trailing-40 % speed and falls, the
        bases over the first 15 steps, and the speed's spread when the start
        is 1e-6 m higher or lower
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_perenv.py witness N
        the port's per-env loop on the CPU against JAX's over N steps, beside
        JAX's own loop from a start 1e-6 m higher
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as tev
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as tdyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import hard_contact as thc
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as ttr
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import dynamics as jdyn
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import hard_contact as jhc
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import terrain as jtr

torch.set_num_threads(1)

ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
JAX_TEST_YAML = "high_speed_quadrupedal_locomotion_by_irrl_tpu/configs/bp5_test.yaml"
B = 4
STEP_N = 10          # chained control steps of the step comparison
BASE_ROWS = 15       # steps of the evaluation whose bases chip_smoke.py holds
NUDGE_M = 1e-6
VARIANTS = {"compliant": {}, "hard": {"hard_contact": True}, "crucial": {"crucial": True},
            "terrain": {"terrain": True}}


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _close(got, want, tol: float, what: str = "") -> None:
    """Largest error relative to max(1, the largest entry of ``want``)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max |err| {err:.3g} x {scale:.3g} > {tol}"


def _state_from_jax(js) -> tbp.EnvState:
    """A batched JAX EnvState as the port's (the PRNG key has no counterpart;
    flat ground is the port's None terrain)."""
    js = jax.tree.map(np.asarray, js)
    kw = {}
    for name in tbp.EnvState.__dataclass_fields__:
        if name == "params":
            kw[name] = tmdl.robot_params_from_numpy(js.params, "cpu")
        elif name == "terrain":
            kw[name] = (ttr.SampledTerrain(*(torch.from_numpy(np.array(a)) for a in js.terrain))
                        if isinstance(js.terrain, jtr.SampledTerrain) else None)
        else:
            kw[name] = torch.from_numpy(np.array(getattr(js, name)))
    return tbp.EnvState(**kw)


def _poses(seed: int, n: int = B, z: float = 0.29):
    """n poses near the stand pose (toes in and out of the ground) and n
    randomized JAX RobotParams with the port's copy."""
    rng = np.random.default_rng(seed)
    gc = np.tile(jmdl.stand_gc(0.0), (n, 1))
    gc[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
    gc[:, 2] = z + rng.uniform(-0.02, 0.02, n)
    q = np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.05, (n, 4))
    gc[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    gc[:, 7:] += rng.uniform(-0.2, 0.2, (n, 12))
    jp = jax.vmap(lambda k: jmdl.randomize(k, jconfig.train_default()))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    return gc.astype(np.float32), jp, tmdl.robot_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _terrains(seed: int, n: int = B, z_scale: float = 0.08):
    jt = jax.vmap(lambda k: jtr.sampled_fractal(k, z_scale))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    return jt, ttr.at_offsets(_t(jt.offset), z_scale)


# --- hard contact ----------------------------------------------------------------------

@pytest.mark.parametrize("terrain", [False, True])
def test_toe_jacobians_and_contact_frames_match_jax(terrain):
    gc, jp, tp = _poses(1)
    jt, tt = _terrains(2) if terrain else (None, None)
    jkin = jax.vmap(jdyn.fk)(jp, gc)
    want_J = jax.vmap(jhc.toe_jacobians)(jkin)
    if terrain:
        gap, basis = jax.vmap(jhc.contact_frames)(jt, jkin.toe_pos)
    else:
        gap, basis = jax.vmap(lambda x: jhc.contact_frames(jtr.flat(), x))(jkin.toe_pos)
    tkin = tdyn.fk(tp, _t(gc))
    _close(thc.toe_jacobians(tkin), want_J, 2e-6, "J")
    got_gap, got_basis = thc.contact_frames(tt, tkin.toe_pos)
    _close(got_gap, gap, 2e-6, "gap")
    _close(got_basis, basis, 2e-6, "basis")
    # the toe Jacobian is the exact linear map of gv to the toe velocities
    gv = _t(np.random.default_rng(3).normal(size=(B, 18)))
    v = tdyn.body_velocities(tkin, gv)
    from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import spatial as tsp
    _close(torch.einsum("bcid,bd->bci", thc.toe_jacobians(tkin), gv),
           tsp.point_velocity(v[:, tdyn.SHANKS], tkin.toe_pos).numpy(), 2e-6, "J gv")


@pytest.mark.parametrize("n_active", [0, 1, 2, 3, 4])
def test_solve_impulses_matches_jax(n_active):
    """The PGS solve of every env with 0-4 active contacts, warm-started and
    with restitution rows, on a tilted terrain's contact bases."""
    rng = np.random.default_rng(10 + n_active)
    gc, jp, _ = _poses(11 + n_active)
    jt, _ = _terrains(12 + n_active)
    jkin = jax.vmap(jdyn.fk)(jp, gc)
    M = np.asarray(jax.vmap(jdyn.mass_matrix)(jp, jkin))
    J = np.asarray(jax.vmap(jhc.toe_jacobians)(jkin))
    _, basis = jax.vmap(jhc.contact_frames)(jt, jkin.toe_pos)
    basis = np.asarray(basis)
    gap = np.abs(rng.uniform(1e-4, 4e-3, (B, 4))).astype(np.float32)
    for b in range(B):
        gap[b, rng.permutation(4)[:n_active]] *= -1.0
    gv_free = rng.normal(0.0, 0.5, (B, 18)).astype(np.float32)
    gv_free[:, 2] -= 0.6                               # falling: the contacts engage
    mu = rng.uniform(0.4, 1.0, B).astype(np.float32)
    rest = rng.uniform(0.0, 0.3, B).astype(np.float32)
    thresh = np.array([0.0, 0.05, 0.3, 2.0], np.float32)[:B]
    lam0 = (np.abs(rng.normal(size=(B, 4, 3))) * 1e-3).astype(np.float32)
    dt = 2.5e-4
    want = jax.vmap(lambda *a: jhc.solve_impulses(*a[:6], dt, 12, lam0=a[6], restitution=a[7],
                                                  res_threshold=a[8]))(
        M, J, gv_free, gap, basis, mu, lam0, rest, thresh)
    got = thc.solve_impulses(*(_t(a) for a in (M, J, gv_free, gap, basis, mu)), dt, 12,
                             lam0=_t(lam0), restitution=_t(rest), res_threshold=_t(thresh))
    _close(got.lam, want.lam, 1e-5, "lam")
    _close(got.gv_plus, want.gv_plus, 1e-5, "gv_plus")
    _close(got.fn, want.fn, 1e-5, "fn")
    _close(got.toe_vel_plus, want.toe_vel_plus, 1e-5, "toe_vel_plus")
    active = gap < 0
    lam = got.lam.numpy()
    assert (lam[~active] == 0).all() and (lam[active, 0] > 0).sum() >= (n_active > 0)


# --- the attack spheres ----------------------------------------------------------------

@pytest.mark.parametrize("terrain", [False, True])
def test_sphere_robot_forces_match_jax(terrain):
    """Spheres against the ground, the base box and the shank capsules."""
    rng = np.random.default_rng(20)
    gc, jp, tp = _poses(21)
    jt, tt = _terrains(22) if terrain else (jtr.flat(), None)
    jkin = jax.vmap(jdyn.fk)(jp, gc)
    C = 6
    radius = rng.uniform(0.06, 0.12, B).astype(np.float32)
    # two spheres on the base box, three on a knee-to-toe segment, one on the ground
    s = rng.uniform(0.2, 0.8, (B, 3, 1))
    knee, toe = np.asarray(jkin.p)[:, jmdl.SHANK_BODY_IDX[:3]], np.asarray(jkin.toe_pos)[:, :3]
    pos = np.concatenate([
        gc[:, None, :3] + rng.uniform(-0.08, 0.08, (B, 2, 3)) * [1.0, 0.6, 0.0]
        + (0.05 + 0.7 * radius)[:, None, None] * [0.0, 0.0, 1.0],
        knee + s * (toe - knee) + rng.uniform(-0.05, 0.05, (B, 3, 3)),
        np.concatenate([gc[:, None, :2] + 0.4, 0.5 * radius[:, None, None]], -1)], 1)
    pos = pos.astype(np.float32)
    vel = rng.normal(0.0, 1.0, (B, C, 3)).astype(np.float32)
    mass = rng.uniform(0.2, 0.6, B).astype(np.float32)
    jcfg, tcfg = jconfig.test_default(), tconfig.test_default().replace(crucial=True)
    if terrain:
        want = jax.vmap(lambda *a: jbp._sphere_robot_forces(jcfg, *a))(
            jp, gc, pos, vel, radius, mass, jt)
    else:
        want = jax.vmap(lambda *a: jbp._sphere_robot_forces(jcfg, *a, jt))(
            jp, gc, pos, vel, radius, mass)
    got = tbp._sphere_robot_forces(tcfg, tp, _t(gc), _t(pos), _t(vel), _t(radius), _t(mass), tt)
    # relative to each output's largest entry: 1e4 N/m stiffness on sub-mm overlaps
    for g, w, what in zip(got, want, ("acc", "wrench")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=what)
    wrench = np.asarray(want[1])
    assert (np.abs(wrench[:, 0]).max(-1) > 0).all(), "no sphere touched the base box"
    assert (np.abs(wrench[:, jmdl.SHANK_BODY_IDX]).max(-1) > 0).sum() >= B, "no shank touched"


# --- the control step ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(variant: str):
    """JAX ``vmap(bp.step)`` under the variant's deployment config, jitted once."""
    jcfg = jconfig.test_default().replace(**VARIANTS[variant])
    return jax.jit(jax.vmap(lambda s, a: jbp.step(jcfg, s, a)))


def _jax_start(variant: str, seed: int = 3):
    """JAX env_init of B deployment-config envs with perturbed joints; under
    the attacks, the spheres launched onto the robot."""
    over = VARIANTS[variant]
    jcfg = jconfig.test_default().replace(**over)
    tcfg = tconfig.test_default().replace(**over)
    rng = np.random.default_rng(seed)
    js = jax.vmap(lambda k: jbp.env_init(jcfg, k))(jax.random.split(jax.random.PRNGKey(seed), B))
    # 7.5 cm below the spawn height: the toes start in the ground
    js = js._replace(gc=js.gc.at[:, 7:].add(jnp.asarray(0.1 * rng.normal(size=(B, 12)),
                                                         jnp.float32)).at[:, 2].add(-0.075))
    if variant == "crucial":
        C = jcfg.num_cube
        pos = np.asarray(js.gc)[:, None, :3] + rng.uniform(-0.15, 0.15, (B, C, 3))
        pos[..., 2] += 0.06
        js = js._replace(cube_pos=jnp.asarray(pos, jnp.float32),
                         cube_vel=jnp.asarray(rng.normal(0.0, 0.5, (B, C, 3)) - [0, 0, 2],
                                              jnp.float32),
                         cube_active=jnp.ones(B, bool))
    actions = (0.3 * rng.normal(size=(STEP_N, B, 12))).astype(np.float32)
    return jcfg, tcfg, js, actions


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_matches_jax_vmap_step(variant):
    """The port's step against JAX ``vmap(bp.step)`` from the same states and
    actions: one control step within 1e-5, ten chained ones within 1e-4
    (each relative to max(1, the largest entry))."""
    _, tcfg, js, actions = _jax_start(variant)
    jstep = _jax_step(variant)
    ts, gen = _state_from_jax(js), torch.Generator().manual_seed(0)
    touched = False
    for i in range(STEP_N):
        ref = jstep(js, jnp.asarray(actions[i]))
        got = tbp.step(tcfg, ts, torch.from_numpy(actions[i]), gen)
        tol = 1e-5 if i == 0 else 1e-4
        for what, g, w in (("gc", got.state.gc, ref.state.gc), ("gv", got.state.gv, ref.state.gv),
                           ("obs", got.obs, ref.obs), ("reward", got.reward, ref.reward),
                           ("torque", got.state.torque_applied, ref.state.torque_applied),
                           ("cube_pos", got.state.cube_pos, ref.state.cube_pos),
                           ("cube_vel", got.state.cube_vel, ref.state.cube_vel)):
            _close(g, w, tol, f"step {i}: {what}")
        # a contact force is the 3e4 N/m stiffness times a penetration that agrees to 1e-9 m,
        # and on terrain the 1000 N s/m damping times the velocity along a normal taken by
        # central differences 2e-3 m apart on float32 heights (1e-6 of slope per ulp)
        _close(got.state.contact_force_norm, ref.state.contact_force_norm,
               5e-3 if variant == "terrain" else 1e-4, f"step {i}: contact force")
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
        np.testing.assert_array_equal(got.state.contact_filtered.numpy(),
                                      np.asarray(ref.state.contact_filtered))
        touched |= bool((np.asarray(ref.state.contact_filtered) > 0).any())
        js, ts = ref.state, got.state
    assert touched, "no toe touched the ground: the contact went untested"
    if variant == "crucial":
        assert (np.abs(np.asarray(ts.cube_vel[..., 2] + 2.0)) > 0.1).any()


def test_step_batch_and_step_share_all_but_the_substeps():
    """From one state and generator seed the two steps draw the same noise
    (training config: action and observation noise, command resampling,
    resets): with the same substep result they return the same state."""
    cfg = tconfig.train_default().replace(action_noise=0.1, force_disturbance=True)
    s = tbp.env_init(cfg, B, torch.Generator().manual_seed(0), "cpu")
    s = s.replace(gc=s.gc.clone().index_fill_(1, torch.tensor([2]), 0.1))   # every env ends
    a = torch.zeros(B, 12)
    outs = [fn(cfg, s, a, torch.Generator().manual_seed(5)) for fn in (tbp.step, tbp.step_batch)]
    assert outs[0].done.all() and outs[1].done.all()
    for name in ("gc", "gv", "command", "obs_double", "joint_ref", "current_time"):
        torch.testing.assert_close(getattr(outs[0].state, name), getattr(outs[1].state, name),
                                   rtol=0, atol=0, msg=name)


def test_getters_match_jax():
    _, tcfg, js, actions = _jax_start("crucial", seed=4)
    ref = _jax_step("crucial")(js, jnp.asarray(actions[0]))
    got = tbp.step(tcfg, _state_from_jax(js), torch.from_numpy(actions[0]),
                   torch.Generator().manual_seed(0))
    for name, tol in (("origin_state", 1e-5), ("reference_state", 1e-5), ("joint_effort", 1e-5),
                      ("generalized_force", 1e-5), ("inverse_mass_matrix", 1e-4),
                      ("nonlinear", 1e-5), ("sphere_info", 1e-5)):
        _close(getattr(tbp, name)(got.state), jax.vmap(getattr(jbp, name))(ref.state), tol, name)


# --- the paths that choose the per-env step ----------------------------------------------

@pytest.mark.parametrize("lanes", [False, True])
def test_rollout_steps_the_physics_its_config_names(lanes, monkeypatch):
    env_cfg = tconfig.train_default().replace(num_envs=2, use_lanes_physics=lanes)
    cfg = tppo.PPOConfig(n_lstm=(8, 8), n_steps=3)
    ts = tppo.init_train_state(env_cfg, cfg, seed=0, device="cpu")
    calls = {"step": 0, "step_batch": 0}
    for name in calls:
        real = getattr(tbp, name)
        monkeypatch.setattr(tbp, name, lambda *a, _n=name, _r=real, **k: (
            calls.__setitem__(_n, calls[_n] + 1) or _r(*a, **k)))
    _, batch, _ = tppo.rollout(env_cfg, cfg, ts)
    assert calls == ({"step": 0, "step_batch": 3} if lanes else {"step": 3, "step_batch": 0})
    assert torch.isfinite(batch.rewards).all()


@pytest.mark.parametrize("variant", ["hard", "crucial"])
def test_eval_rollout_under_hard_contact_and_attacks_matches_jax(variant):
    """analysis.eval.policy_rollout of the flagship at cmd 1 and 3 (JAX: one
    rollout a command on its per-env step): bases within 1e-4 over 10 steps."""
    over = VARIANTS[variant]
    jcfg = jev._fixed_command_cfg(jconfig.test_default().replace(**over))
    tcfg = tev._fixed_command_cfg(tconfig.test_default().replace(**over))
    jp = jio.load_bp5_csv(ARTIFACT)
    tp = tio.load_bp5_csv(ARTIFACT, device="cpu")
    cmds = np.array([[1.0, 0.0, 0.0], [3.0, 0.0, 0.0]], np.float32)
    got = tev.policy_rollout(tcfg, tp, cmds, torch.Generator().manual_seed(0), STEP_N,
                             device="cpu")
    for b, cmd in enumerate(cmds):
        want = jev.policy_rollout(jcfg, jp, jnp.asarray(cmd), jax.random.PRNGKey(0), STEP_N)
        _close(got.gc[:, b], want.gc, 1e-4, f"cmd {cmd[0]} gc")
        _close(got.action[:, b], want.action, 1e-4, f"cmd {cmd[0]} action")


def test_cli_test_eval_runs_a_hard_contact_yaml(tmp_path, monkeypatch, capsys):
    """cli.test --eval --cfg <bp5_test.yaml with HardContact: true>
    (scripts/hard_contact_eval.py's protocol) rolls on the per-env step."""
    import yaml
    from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as tcli_test
    with open(JAX_TEST_YAML) as f:
        doc = yaml.safe_load(f)
    doc["environment"]["HardContact"] = True
    path = str(tmp_path / "bp5_test_hard.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    calls = []
    real = tbp.step
    monkeypatch.setattr(tbp, "step", lambda *a, **k: calls.append(1) or real(*a, **k))
    res = tcli_test.main(["--model", ARTIFACT, "--cfg", path, "--eval", "--commands", "1,2",
                          "--steps", "4", "--device", "cpu"])
    assert len(calls) == 4 and len(res["tracking"]) == 2
    assert all(np.isfinite(r["v_mean"]) for r in res["tracking"])
    assert "cmd 2.0 m/s -> v " in capsys.readouterr().out


# --- script modes ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loops(jcfg, n_steps: int):
    """JAX's analysis.eval.policy_rollout under ``jcfg``, jitted once and
    vmapped over (command, start-height change) pairs: (params, cmds (K,),
    dz (K,)) -> gc (K, T, 19), gv (K, T, 18), done (K, T)."""
    jcfg = jev._fixed_command_cfg(jcfg)

    def one(jp, cmd, dz):
        command = jnp.stack([cmd, 0.0, 0.0])
        state = jbp.env_init(jcfg, jax.random.PRNGKey(jcfg.seed))
        state = state._replace(gc=state.gc.at[2].add(dz), command=command,
                               command_filtered=command)
        cmd_n = (command - jbp.obs_mean(jcfg)[:3]) / jbp.obs_std(jcfg)[:3]
        s_size = jlstm.state_size([w.wh.shape[0] for w in jp.pi_lstm])

        def body(carry, _):
            st, h, obs = carry
            action, h = jlstm.deterministic_action(jp, obs.at[:3].set(cmd_n)[None], h[None],
                                                   jnp.zeros((1,)))
            out = jbp.step(jcfg, st._replace(command=command, command_filtered=command),
                           action[0])
            return (out.state, h[0], out.obs), (out.state.gc, out.state.gv, out.done)

        _, out = jax.lax.scan(body, (state, jnp.zeros(s_size), jbp.observe(jcfg, state)), None,
                              length=n_steps)
        return out

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))


def _jax_loop(jcfg, jp, cmds, n_steps: int, dz=None):
    cmds = np.asarray(cmds, np.float32)
    dz = np.zeros_like(cmds) if dz is None else np.asarray(dz, np.float32)
    return tuple(np.asarray(x) for x in _jax_loops(jcfg, n_steps)(jp, cmds, dz))


def _speed(gc: np.ndarray, gv: np.ndarray) -> float:
    """tracking_eval's trailing-40 % forward speed (body frame)."""
    R = np.asarray(jax.vmap(jbp.quat_to_matrix)(jnp.asarray(gc[:, 3:7])))
    vb = np.einsum("tji,tj->ti", R, gv[:, :3])
    return float(vb[int(len(gc) * 0.6):, 0].mean())


def phase15_references(n_steps: int, commands=(1.0, 2.0, 3.0, 4.0, 5.0)) -> dict:
    """JAX's evaluation of the flagship under hard contact and under the
    attacks: chip_smoke.py phase 15 (a) and (b)."""
    jp = jio.load_bp5_csv(ARTIFACT)
    out = {}
    for variant in ("hard", "crucial"):
        jcfg = jconfig.test_default().replace(terrain=False, **VARIANTS[variant])
        K = len(commands)
        gc, gv, done = _jax_loop(jcfg, jp, list(commands) * 3, n_steps,
                                 [0.0] * K + [NUDGE_M] * K + [-NUDGE_M] * K)
        rows = {}
        for i, cmd in enumerate(commands):
            v = _speed(gc[i], gv[i])
            spread = max(abs(_speed(gc[j], gv[j]) - v) for j in (K + i, 2 * K + i))
            rows[cmd] = {"v": v, "falls": int(done[i].sum()), "nudge_spread": spread,
                         "bases": gc[i, :BASE_ROWS, :3].tolist()}
            print(f"{variant} cmd {cmd:g}: v {v:.6f} falls {int(done[i].sum())} nudge spread "
                  f"{spread:.6f}", file=sys.stderr, flush=True)
        out[variant] = rows
    return out


def witness(n_steps: int, commands=(1.0, 3.0, 5.0)) -> None:
    """The port's per-env loop (plain PyTorch on the CPU) against JAX's over
    ``n_steps``, beside JAX's own loop from a start 1e-6 m higher: the largest
    base difference at steps 10, 50, 100, ... and the trailing speeds."""
    jp = jio.load_bp5_csv(ARTIFACT)
    tp = tio.load_bp5_csv(ARTIFACT, device="cpu")
    marks = [m for m in (10, 50, 100, 200, 500, 1000, 2000) if m <= n_steps]
    for variant in ("compliant", "hard", "crucial"):
        jcfg = jconfig.test_default().replace(**VARIANTS[variant])
        tcfg = tev._fixed_command_cfg(tconfig.test_default().replace(**VARIANTS[variant]))
        log = tev.policy_rollout(tcfg, tp, np.array([[c, 0.0, 0.0] for c in commands]),
                                 torch.Generator().manual_seed(0), n_steps, device="cpu")
        K = len(commands)
        gc, gv, _ = _jax_loop(jcfg, jp, list(commands) * 2, n_steps, [0.0] * K + [NUDGE_M] * K)
        for b, cmd in enumerate(commands):
            port = log.gc[:, b].numpy()
            d_port = np.abs(port[:, :3] - gc[b, :, :3]).max(1)
            d_nudge = np.abs(gc[K + b, :, :3] - gc[b, :, :3]).max(1)
            print(f"{variant} cmd {cmd:g}: bases port-JAX "
                  + ", ".join(f"@{m} {d_port[m - 1]:.2e}" for m in marks)
                  + "; JAX nudged-JAX " + ", ".join(f"@{m} {d_nudge[m - 1]:.2e}" for m in marks)
                  + f"; v port {_speed(port, log.gv[:, b].numpy()):.4f} JAX "
                  f"{_speed(gc[b], gv[b]):.4f} nudged {_speed(gc[K + b], gv[K + b]):.4f}",
                  flush=True)


if __name__ == "__main__":
    mode, n = sys.argv[1], int(sys.argv[2])
    if mode == "refs":
        print(json.dumps(phase15_references(n)))
    elif mode == "witness":
        witness(n)
    else:
        raise SystemExit(f"unknown mode {mode!r}: refs N | witness N")
