"""PyTorch port: the batched MDP against the JAX package.

The port's ``step_batch`` is held against JAX ``vmap(bp.step)`` from the same
states (JAX's ``env_init`` carried over) and actions, under the deployment
config, where no random draw reaches the result. Pure functions (torque
clamp, motor model, reward, gait reference) are compared on random numpy
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as ttr
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait as tgait
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.robot import gait as jgait

torch.set_num_threads(1)


def state_from_jax(js) -> tbp.EnvState:
    """A batched JAX EnvState of a flat config as the port's (the PRNG key,
    the flat terrain and the attack-sphere fields have no counterpart)."""
    js = jax.tree.map(np.asarray, js)
    kw = {}
    for name in tbp.EnvState.__dataclass_fields__:
        if name == "params":
            kw[name] = tmdl.robot_params_from_numpy(js.params, "cpu")
        elif name == "terrain":
            kw[name] = None
        else:
            kw[name] = torch.from_numpy(np.array(getattr(js, name)))
    return tbp.EnvState(**kw)


def test_step_batch_matches_jax_vmap_step():
    B = 8
    jcfg, tcfg = jconfig.test_default(), tconfig.test_default()
    rng = np.random.default_rng(4)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js = jax.vmap(lambda k: jbp.env_init(jcfg, k))(keys)
    # perturbed joints so the PD loop and the contacts do real work
    js = js._replace(gc=js.gc.at[:, 7:].add(jnp.asarray(0.1 * rng.normal(size=(B, 12)),
                                                         jnp.float32)))
    actions = (0.3 * rng.normal(size=(B, 12))).astype(np.float32)

    ref = jax.jit(jax.vmap(lambda s, a: jbp.step(jcfg, s, a)))(js, jnp.asarray(actions))
    gen = torch.Generator().manual_seed(0)
    got = tbp.step_batch(tcfg, state_from_jax(js), torch.from_numpy(actions), gen)

    # the tolerances of the JAX step_batch-vs-vmap(step) test
    # (test_phys_lanes.py:116-124): same physics, another summation order
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), atol=2e-3)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), atol=2e-3)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))
    np.testing.assert_allclose(got.state.gc.numpy(), np.asarray(ref.state.gc), atol=1e-4)
    np.testing.assert_allclose(got.state.gv.numpy(), np.asarray(ref.state.gv), atol=2e-2)
    np.testing.assert_allclose(got.state.torque_applied.numpy(),
                               np.asarray(ref.state.torque_applied), atol=2e-3)
    np.testing.assert_array_equal(got.state.contact_filtered.numpy(),
                                  np.asarray(ref.state.contact_filtered))
    np.testing.assert_allclose(got.state.reward_terms.numpy(),
                               np.asarray(ref.state.reward_terms), atol=2e-3)
    np.testing.assert_allclose(got.state.current_time.numpy(),
                               np.asarray(ref.state.current_time), atol=0)


def test_env_init_matches_jax_under_test_config():
    B = 3
    js = jax.vmap(lambda k: jbp.env_init(jconfig.test_default(), k))(
        jax.random.split(jax.random.PRNGKey(0), B))
    ts = tbp.env_init(tconfig.test_default(), B, torch.Generator().manual_seed(0), "cpu")
    want = state_from_jax(js)
    for name in tbp.EnvState.__dataclass_fields__:
        if name not in ("params", "terrain"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), getattr(want, name).numpy(),
                                       atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tbp.observe(tconfig.test_default(), ts).numpy(),
                               np.asarray(jax.vmap(lambda s: jbp.observe(
                                   jconfig.test_default(), s))(js)), atol=1e-6)


def test_torque_clamp_and_real_torque_match_jax():
    rng = np.random.default_rng(0)
    tau = (30.0 * rng.normal(size=(64, 12))).astype(np.float32)
    qd = (40.0 * rng.normal(size=(64, 12))).astype(np.float32)
    for jc, tc in ((jconfig.test_default(), tconfig.test_default()),
                   (jconfig.train_default(), tconfig.train_default())):
        np.testing.assert_allclose(
            tbp.torque_clamp(tc, torch.from_numpy(tau), torch.from_numpy(qd)).numpy(),
            np.asarray(jbp.torque_clamp(jc, tau, qd)), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tbp.real_torque(torch.from_numpy(tau), torch.from_numpy(qd)).numpy(),
                               np.asarray(jbp.real_torque(tau, qd)), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("motor_dynamics", [False, True])
def test_pd_torque_matches_jax(motor_dynamics):
    """PD -> smoothing quirk -> motor model -> envelope clamp, the function the
    fused control step carries into its kernel, under both configs."""
    rng = np.random.default_rng(5)
    f = lambda scale: (scale * rng.normal(size=(64, 12))).astype(np.float32)  # noqa: E731
    pt, tnl, q, qd = f(1.0), f(0.5), f(1.0), f(15.0)
    qd[0] = 0.0   # sign(0) = 0 in the motor friction
    for jc, tc in ((jconfig.test_default(), tconfig.test_default()),
                   (jconfig.train_default().replace(abad_ratio=0.5),
                    tconfig.train_default().replace(abad_ratio=0.5))):
        jc, tc = jc.replace(motor_dynamics=motor_dynamics), tc.replace(motor_dynamics=motor_dynamics)
        got = pd_torque.pd_torque(pd_torque.from_config(tc), *(torch.from_numpy(x)
                                                               for x in (pt, tnl, q, qd)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jbp._pd_torque(jc, pt, tnl, q, qd)),
                                   atol=1e-5, rtol=1e-6)


def _pd_torque_from_packed(consts, motor_dynamics, pt, tnl, q, qd):
    """The control-step kernel's torque formula (csrc/phys_substep.cu,
    pd_torque) in float32 numpy, from the 22 floats the kernel is handed."""
    f = np.float32
    c = [f(x) for x in consts]
    by_link = lambda i: np.tile(np.array(c[i:i + 3], f), 4)  # noqa: E731
    kp, kd, kr, gear = by_link(0), by_link(3), by_link(6), by_link(9)
    tm, cs, ms, slope, kt, r, tau_max, batt, damp, fric = c[12:22]
    tau = kp * (pt - q) - kd * qd
    tau = f(0.99) * tau + f(0.01) * tnl
    if motor_dynamics:
        i_des = tau / gear / (kt * f(1.5))
        bemf = qd * gear * kt * f(2.0)
        v_act = np.clip(i_des * r + bemf, -batt, batt)
        tau_act = (f(1.5) * kt) * (v_act - bemf) / r
        tau = gear * np.clip(tau_act, -tau_max, tau_max) - damp * qd - fric * np.sign(qd)
    w = qd * kr
    up = np.where(w > cs, tm - (w - cs) * slope, tm) * kr
    low = np.where(w < -cs, (-ms - w) / (-ms + cs) * -tm, -tm) * kr
    return np.minimum(np.maximum(tau, low), up)


@pytest.mark.parametrize("motor_dynamics", [False, True])
def test_packed_pd_consts_reproduce_jax_pd_torque(motor_dynamics):
    """The constants reach the kernel by value, in one fixed order: that
    order, read as the kernel reads it, gives the JAX package's torque."""
    rng = np.random.default_rng(6)
    g = lambda scale: (scale * rng.normal(size=(64, 12))).astype(np.float32)  # noqa: E731
    pt, tnl, q, qd = g(1.0), g(0.5), g(1.0), g(15.0)
    qd[0] = 0.0
    jc = jconfig.train_default().replace(abad_ratio=0.5, motor_dynamics=motor_dynamics)
    tc = tconfig.train_default().replace(abad_ratio=0.5, motor_dynamics=motor_dynamics)
    consts = phys_cuda.pack_pd_consts(pd_torque.from_config(tc))
    assert len(consts) == 22
    got = _pd_torque_from_packed(consts, motor_dynamics, pt, tnl, q, qd)
    np.testing.assert_allclose(got, np.asarray(jbp._pd_torque(jc, pt, tnl, q, qd)),
                               atol=1e-5, rtol=1e-6)


def test_gear_ratios_must_repeat_leg_by_leg(monkeypatch):
    """The kernel takes the gear ratios by link of a leg; a model whose legs
    differ is refused, not silently read from the first leg."""
    assert pd_torque.from_config(tconfig.test_default()).gear == tuple(
        float(x) for x in tmdl.GEAR_RATIO[:3])
    gear = np.array(tmdl.GEAR_RATIO, dtype=np.float64)
    gear[7] += 1.0
    monkeypatch.setattr(tmdl, "GEAR_RATIO", gear)
    with pytest.raises(ValueError, match="gear ratios"):
        pd_torque.real_torque(torch.zeros(2, 12), torch.zeros(2, 12))


def test_deep_mimic_reward_matches_jax():
    B = 16
    rng = np.random.default_rng(1)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    q = f(B, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    gc = np.concatenate([f(B, 2), 0.3 + f(B, 1, scale=0.02), q, f(B, 12, scale=0.5)], -1)
    R = np.asarray(jax.vmap(lambda x: jbp.quat_to_matrix(x))(q))
    args = dict(t=np.abs(f(B)), gc=gc, gv=f(B, 18), obs_double=f(B, 35, scale=0.2),
                v_body=f(B, 3), w_body=f(B, 3), R=R, toe_pos=f(B, 4, 3, scale=0.3),
                joint_ref=f(B, 12, scale=0.5), joint_dot_ref=f(B, 12, scale=3.0),
                ee_ref=f(B, 12, scale=0.3), command_filtered=f(B, 3),
                torque_applied=f(B, 12, scale=5.0), torque_norm_last=f(B, 12, scale=0.2),
                contact_vel_norm=np.abs(f(B, 4)), contact_force_norm=np.abs(f(B, 4, scale=10.0)))
    for jc, tc in ((jconfig.test_default(), tconfig.test_default()),
                   (jconfig.train_default().replace(ee_coeff=0.2, contact_coeff=0.1),
                    tconfig.train_default().replace(ee_coeff=0.2, contact_coeff=0.1))):
        want = jax.vmap(lambda *a: jbp.deep_mimic_reward(jc, *a))(*args.values())
        got = tbp.deep_mimic_reward(tc, *(torch.from_numpy(np.array(v)) for v in args.values()))
        np.testing.assert_allclose(got.terms.numpy(), np.asarray(want.terms), atol=1e-5)
        np.testing.assert_allclose(got.total.numpy(), np.asarray(want.total), atol=1e-5)
        np.testing.assert_allclose(got.torque_norm.numpy(), np.asarray(want.torque_norm),
                                   atol=1e-6)


@pytest.mark.parametrize("wildcat", [False, True])
def test_gait_reference_matches_jax(wildcat):
    B = 32
    rng = np.random.default_rng(2)
    cmd = np.stack([rng.uniform(-5, 5, B), rng.uniform(-0.5, 0.5, B),
                    rng.uniform(-1, 1, B)], -1).astype(np.float32)
    t = rng.uniform(0, 3, B).astype(np.float32)
    jc = jconfig.train_default().replace(wildcat=wildcat, height_variable=True, vy_max=0.5)
    tc = tconfig.train_default().replace(wildcat=wildcat, height_variable=True, vy_max=0.5)
    want = jax.vmap(lambda c, tt: jgait.gait_reference(jc, c, tt))(cmd, t)
    got = tgait.gait_reference(tc, torch.from_numpy(cmd), torch.from_numpy(t))
    np.testing.assert_allclose(got.joint_ref.numpy(), np.asarray(want.joint_ref), atol=2e-5)
    np.testing.assert_allclose(got.ee_ref.numpy(), np.asarray(want.ee_ref), atol=1e-6)


def test_training_config_steps_and_resets():
    """The non-manual branches (command resampling, Bezier references, noisy
    reset and obs, domain randomization) run and keep their invariants."""
    cfg = tconfig.train_default()
    gen = torch.Generator().manual_seed(0)
    s = tbp.env_init(cfg, 4, gen, "cpu")
    assert s.params.mass.shape == (4, 13)
    assert (s.command[:, 0] >= 0).all() and (s.command[:, 0] <= cfg.vx_max).all()
    assert torch.isfinite(s.joint_dot_ref).all() and (s.ee_ref != 0).any()
    out = tbp.step_batch(cfg, s, torch.zeros(4, 12), gen)
    assert out.obs.shape == (4, 35) and torch.isfinite(out.obs).all()
    assert (out.state.frame_idx == 2).all() | out.done.any()
    forced = tbp.step_batch(cfg, out.state.replace(gc=out.state.gc.clone().index_fill_(
        1, torch.tensor([2]), 0.05)), torch.zeros(4, 12), gen)
    assert forced.done.all()
    assert (forced.state.frame_idx == 1).all() and (forced.state.ep_len == 0).all()
    np.testing.assert_allclose(forced.reward.numpy(),
                               forced.info["reward_terms"].sum(-1).numpy() + cfg.terminal_reward,
                               atol=1e-6)


@pytest.mark.parametrize("flag", ["crucial", "hard_contact", "terrain"])
def test_unported_modes_raise(flag):
    # the analytic fractal terrain runs: on JAX's seeds env_init spawns where JAX's
    # does (heights within 1e-3 m: the float32 hash), and both control steps step it
    if flag == "terrain":
        jcfg = jconfig.test_default().replace(terrain=True, terrain_sampled=False)
        cfg = tconfig.test_default().replace(terrain=True, terrain_sampled=False)
        js = jax.vmap(lambda k: jbp.env_init(jcfg, k))(jax.random.split(jax.random.PRNGKey(0), 2))
        gen = torch.Generator().manual_seed(0)
        s = tbp.env_init(cfg, 2, gen, "cpu",
                         terrain_seed=torch.from_numpy(np.array(js.terrain.seed)))
        assert isinstance(s.terrain, ttr.TerrainParams)
        np.testing.assert_allclose(s.gc.numpy(), np.asarray(js.gc), atol=1e-3, rtol=0)
        assert np.abs(np.asarray(js.gc)[:, 2] - tmdl.stand_gc(0.0)[2]).max() > 1e-3
        np.testing.assert_allclose(tbp.observe(cfg, s).numpy(),
                                   np.asarray(jax.vmap(lambda x: jbp.observe(jcfg, x))(js)),
                                   atol=1e-6)
        for step in (tbp.step_batch, tbp.step):
            assert torch.isfinite(step(cfg, s, torch.zeros(2, 12), gen).state.gc).all()
        return
    # the attacks and hard contact run on the per-env step only; step_batch refuses
    # them, as the JAX package's asserts (blackpanther.py:809-812), and names step
    cfg = tconfig.test_default().replace(**{flag: True})
    gen = torch.Generator().manual_seed(0)
    s = tbp.env_init(cfg, 2, gen, "cpu")
    with pytest.raises(ValueError, match=f"cfg.{flag} .* use envs.blackpanther.step"):
        tbp.step_batch(cfg, s, torch.zeros(2, 12), gen)
    assert torch.isfinite(tbp.step(cfg, s, torch.zeros(2, 12), gen).obs).all()
