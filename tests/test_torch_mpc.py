"""PyTorch port: the SRB closed loop against the JAX package.

The Convert2Torque inputs of the PD law and of the plain control step, the
whole slice (``mpc/runtime.mpc_rollout`` with torque control under
``speed_schedule(cfg, 1.0)``, 100 control steps, and the PD-position path),
``analysis/parity.srb_vs_bp5`` on the flagship artifact, and the port's
``cli.mpc`` end to end on the CPU. JAX rollouts are compiled once a file.

The port steps the batched lanes physics; the JAX ``mpc_rollout`` steps the
per-env ``bp.step`` (``phys/dynamics.py``), as the evaluation path does
(ROADMAP.md Queue 3): another summation order, so the two trajectories agree
to rounding over the first steps and drift apart slowly after contact events.
"""

import os
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
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime as truntime
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb as tsrb
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as tlanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import parity as jparity
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import rawdata as jrawdata
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import runtime as jruntime
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import srb as jsrb
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops import phys_lanes as jlanes
from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import model as jmdl

torch.set_num_threads(1)

ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
LOOP_STEPS = 100
TIGHT_STEPS = 30


def _pd_inputs(B, seed):
    """PD inputs (B, 12) around the stand pose, joint speeds into the motor
    envelope's speed-dependent part, and the Convert2Torque pair."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jmdl.stand_gc(0.0))[7:] + 0.2 * rng.normal(size=(B, 12))
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(ptarget=f(q + 0.3 * rng.normal(size=(B, 12))),
                tnl=f(0.5 * rng.normal(size=(B, 12))), q=f(q), qd=f(15.0 * rng.normal(size=(B, 12))),
                tau_ff=f(8.0 * rng.normal(size=(B, 12))),
                pd_scale=f(rng.uniform(0.0, 1.5, size=(B, 12))))


@pytest.mark.parametrize("motor_dynamics", [False, True])
@pytest.mark.parametrize("which", ["both", "tau_ff", "pd_scale", "none"])
def test_pd_torque_convert2torque_matches_jax(motor_dynamics, which):
    jcfg = jconfig.test_default().replace(motor_dynamics=motor_dynamics)
    tcfg = tconfig.test_default().replace(motor_dynamics=motor_dynamics)
    x = _pd_inputs(64, 0)
    ff = x["tau_ff"] if which in ("both", "tau_ff") else None
    ps = x["pd_scale"] if which in ("both", "pd_scale") else None
    want = jbp._pd_torque(jcfg, x["ptarget"], x["tnl"], x["q"], x["qd"], tau_ff=ff, pd_scale=ps)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = pd_torque.pd_torque(pd_torque.from_config(tcfg), t(x["ptarget"]), t(x["tnl"]),
                              t(x["q"]), t(x["qd"]), t(ff), t(ps))
    # the same elementwise f32 chain; the gains' products round once more in JAX
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("motor_dynamics", [False, True])
def test_plain_control_step_convert2torque_matches_jax(motor_dynamics):
    """The plain control step with both inputs against the JAX _pd_torque and
    phys_lanes.substep iterated 8 times, at the closed loop's impulse scale."""
    B = 8
    jcfg = jconfig.test_default().replace(motor_dynamics=motor_dynamics)
    tcfg = tconfig.test_default().replace(motor_dynamics=motor_dynamics)
    imp = 2.0 / jcfg.simulation_dt
    rng = np.random.default_rng(3)
    gc = np.tile(np.asarray(jmdl.stand_gc(0.0)), (B, 1))
    gc[:, 2] = 0.30
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gv = 0.5 * rng.normal(size=(B, 18))
    gv[:, 6:] *= 30.0
    bw = np.concatenate([20.0 * rng.normal(size=(B, 3)), rng.normal(size=(B, 3))], -1)
    gc, gv, bw = (a.astype(np.float32) for a in (gc, gv, bw))
    x = _pd_inputs(B, 4)
    jp = jmdl.nominal_params(jcfg)
    jP = jlanes.params_to_lanes(jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jp))
    gcT, gvT = jnp.asarray(gc.T), jnp.asarray(gv.T)
    for _ in range(jcfg.substeps):
        tau = jbp._pd_torque(jcfg, x["ptarget"], x["tnl"], gcT[7:].T, gvT[6:].T,
                             tau_ff=x["tau_ff"], pd_scale=x["pd_scale"])
        gcT, gvT, toe, toe_vel, fnorm, fn = jlanes.substep(
            jP, gcT, gvT, tau.T, jnp.asarray(bw.T), jcfg.contact_slip_vel, imp,
            jcfg.simulation_dt)
    want = (gcT, gvT, toe, toe_vel, fnorm, fn, tau.T)

    P = tlanes.params_to_lanes(tmdl.nominal_params(tcfg, "cpu").expand(B))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    got = phys_cuda.control_step(P, pd_torque.from_config(tcfg), t(gc), t(gv), t(x["ptarget"]),
                                 t(x["tnl"]), t(bw), tcfg.substeps, tcfg.contact_slip_vel, imp,
                                 tcfg.simulation_dt, t(x["tau_ff"]), t(x["pd_scale"]))
    assert (np.asarray(want[5]) > 0).any(), "no toe in contact: the contact branch went untested"
    # the tolerances of the PD-path control step test (test_torch_phys.py)
    for i, (atol, rtol) in enumerate(((1e-5, 0), (1e-2, 0), (1e-5, 0), (1e-2, 0), (5e-2, 1e-3),
                                      (5e-2, 1e-3), (2e-3, 0))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=atol, rtol=rtol,
                                   err_msg=f"output {i}")


@pytest.fixture(scope="module")
def jax_rollouts():
    """JAX mpc_rollout at cmd 1: the torque-control loop of speed_schedule for
    LOOP_STEPS steps, and the PD-position loop (default config, horizon 8)
    for 10; one compile each."""
    cmd = jnp.array([1.0, 0.0, 0.0])
    env, scfg, kw = jruntime.speed_schedule(jconfig.test_default(), 1.0)
    torque = jruntime.mpc_rollout(env, scfg, cmd, jax.random.PRNGKey(0), LOOP_STEPS, **kw)
    pd = jruntime.mpc_rollout(jconfig.test_default(), jsrb.SRBConfig(horizon=8), cmd,
                              jax.random.PRNGKey(0), 10)
    return {"torque": jax.tree.map(np.asarray, torque), "pd": jax.tree.map(np.asarray, pd)}


def test_mpc_rollout_torque_control_matches_jax(jax_rollouts):
    """The slice as a whole: 100 closed-loop steps at cmd 1 (speed_schedule)."""
    env, scfg, kw = truntime.speed_schedule(tconfig.test_default(), 1.0)
    got = truntime.mpc_rollout(env, scfg, np.array([1.0, 0.0, 0.0], np.float32),
                               torch.Generator().manual_seed(0), LOOP_STEPS, device="cpu", **kw)
    got = {k: getattr(got, k).numpy() for k in got._fields}
    want = jax_rollouts["torque"]
    assert got["gc"].shape == (LOOP_STEPS, 19) and got["forces0"].shape == (LOOP_STEPS, 4, 3)
    n = TIGHT_STEPS
    # first 30 steps: rounding only (measured 2.4e-7 on gc, 3.6e-7 on actions,
    # 4e-6 relative on the cost, 7e-5 N on the first knot's forces)
    np.testing.assert_allclose(got["gc"][:n], want.gc[:n], atol=2e-6)
    np.testing.assert_allclose(got["action"][:n], want.action[:n], atol=2e-6)
    np.testing.assert_allclose(got["solve_cost"][:n], want.solve_cost[:n], rtol=4e-5)
    np.testing.assert_allclose(got["forces0"][:n], want.forces0[:n], atol=1e-3)
    np.testing.assert_allclose(got["torque"][:n], want.torque[:n], atol=2e-4)
    # all 100: the two physics drift apart after touchdowns (measured 1.8e-4 on
    # gc, 3.6e-5 on actions, 0.9 % on the cost)
    np.testing.assert_allclose(got["gc"], want.gc, atol=2e-3)
    np.testing.assert_allclose(got["action"], want.action, atol=4e-4)
    np.testing.assert_allclose(got["solve_cost"], want.solve_cost, rtol=0.05)
    np.testing.assert_array_equal(got["done"], want.done)
    assert not want.done.any() and got["gv"][-1, 0] > 0.1


def test_mpc_rollout_pd_path_matches_jax(jax_rollouts):
    """The PD-position interface: the first knot's us as the action."""
    got = truntime.mpc_rollout(tconfig.test_default(), tsrb.SRBConfig(horizon=8),
                               np.array([1.0, 0.0, 0.0], np.float32),
                               torch.Generator().manual_seed(0), 10, device="cpu")
    want = jax_rollouts["pd"]
    # measured 1.2e-7 on gc, 3e-7 on actions over the 10 steps
    np.testing.assert_allclose(got.gc.numpy(), want.gc, atol=2e-6)
    np.testing.assert_allclose(got.action.numpy(), want.action, atol=2e-6)
    np.testing.assert_allclose(got.solve_cost.numpy(), want.solve_cost, rtol=4e-5)


def test_batched_commands_roll_per_env():
    """Two commands of one schedule in one batch compute what each computes alone."""
    env, scfg, kw = truntime.speed_schedule(tconfig.test_default(), 1.0)
    cmds = np.array([[1.0, 0.0, 0.0], [2.5, 0.0, 0.0]], np.float32)
    batch = truntime.mpc_rollout(env, scfg, cmds, torch.Generator(), 3, device="cpu", **kw)
    for b in range(2):
        one = truntime.mpc_rollout(env, scfg, cmds[b], torch.Generator(), 3, device="cpu", **kw)
        for name in one._fields:
            # another batch width changes the summation order of the batched products
            torch.testing.assert_close(getattr(batch, name)[:, b], getattr(one, name),
                                       atol=1e-5, rtol=1e-5, msg=name)


def test_srb_vs_bp5_matches_jax():
    """The SRB plan against the flagship policy over the horizon, at a small
    warmup and horizon."""
    warmup, horizon = 20, 8
    want = jparity.srb_vs_bp5(jconfig.test_default(), jio.load_bp5_csv(ARTIFACT), 1.0,
                              horizon=horizon, warmup=warmup)
    got = tparity.srb_vs_bp5(tconfig.test_default(), tio.load_bp5_csv(ARTIFACT, device="cpu"),
                             1.0, horizon=horizon, warmup=warmup, device="cpu")
    # the policy's 28 steps agree to ~1e-3 on actions (test_torch_eval.py); the
    # plan from the state they reach to the same order
    np.testing.assert_allclose(got["bp5_actions"], want["bp5_actions"], atol=5e-3)
    np.testing.assert_allclose(got["srb_actions"], want["srb_actions"], atol=5e-3)
    for k in ("mae", "mae_stance", "mae_swing"):
        assert abs(got[k] - want[k]) < 2e-3, (k, got[k], want[k])


def test_cli_mpc_dump_info_roundtrip(tmp_path):
    path = str(tmp_path / "info.csv")
    res = tcli.main(["--engine", "srb", "--vx", "1", "--steps", "20", "--device", "cpu",
                     "--dump-info", path])
    (row,) = res["rows"]
    assert row["command"] == 1.0 and row["falls"] == 0 and np.isfinite(row["v_mean"])
    info = trawdata.RobotInfo(path)
    assert info.q.shape == (20, 12) and info.contact.shape == (20, 4)
    assert set(np.unique(info.contact)) <= {0.0, 1.0}
    ref = jrawdata.RobotInfo(path)   # the JAX reader reads what the port wrote
    np.testing.assert_array_equal(info.tau, ref.tau)
    np.testing.assert_allclose(info.vel_body, ref.vel_body, atol=1e-12)


def test_cli_mpc_contact_flags_match_jax_fk():
    """Toe-height contact flags through the port's FK against the JAX FK's."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import dynamics as jdyn
    rng = np.random.default_rng(7)
    gc = np.tile(np.asarray(jmdl.stand_gc(0.0)), (16, 1))
    gc[:, 2] = rng.uniform(0.30, 0.36, 16)
    gc[:, 7:] += 0.1 * rng.normal(size=(16, 12))
    gc = gc.astype(np.float32)
    params = jmdl.nominal_params(jconfig.test_default())
    toe = np.asarray(jax.vmap(lambda g: jdyn.fk(params, g).toe_pos)(jnp.asarray(gc)))
    want = (toe[..., 2] < jmdl.TOE_RADIUS + 1e-3).astype(np.float32)
    got = tcli.toe_contact(torch.from_numpy(gc)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_cli_mpc_raises_for_what_is_not_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="whole-body iLQR"):
        tcli.main(["--engine", "wb", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="viewer"):
        tcli.main(["--vx", "1", "--viewer", os.devnull, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--vx", "1", "--steps", "1"])


def closed_loop_reference(n_steps: int, commands=(1.0, 2.0, 3.0, 4.0, 5.0)) -> dict:
    """What chip_smoke.py holds its closed-loop phase to: the JAX package's
    ``cli/mpc.py --engine srb`` rows on the CPU, unrounded: each command's mean
    body-frame forward velocity over the trailing 40 % of ``n_steps`` and its
    fall count."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
    out = {}
    for vx in commands:
        env, scfg, kw = jruntime.speed_schedule(jconfig.test_default(), vx)
        log = jruntime.mpc_rollout(env, scfg, jnp.array([vx, 0.0, 0.0]), jax.random.PRNGKey(0),
                                   n_steps, **kw)
        out[vx] = (float(jev.body_velocity(log)[int(n_steps * 0.6):, 0].mean()),
                   int(np.asarray(log.done).sum()))
    return out


def _jax_lanes_rollout(cfg, scfg, command, n_steps: int, stance_pd=1.0, swing_pd=1.0):
    """JAX's mpc_rollout (torque control) with the env stepped through the JAX
    package's lanes physics (its step_batch, with the Convert2Torque inputs
    added to _pd_torque), the path the port's loop takes. -> (gc, gv, cost)."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.phys import dynamics as jdyn
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.robot import gait as jgait

    cfg = cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0, stochastic_dynamics=False)
    stand = jmdl.stand_gc(cfg.abad)[7:]

    def step(states, action, tau_ff, pd_scale):
        keys = jax.vmap(lambda k: jax.random.split(k, 6))(states.key)
        key, k_act, k_cmd, k_obs, k_attack, k_reset = (keys[:, i] for i in range(6))
        pre, _ = jax.vmap(lambda s, a, ka, kt: jbp._pre_substeps(cfg, s, a, ka, kt))(
            states, action, k_act, k_attack)
        P = jlanes.params_to_lanes(states.params)

        def substep(carry, _):
            gcT, gvT = carry
            tau = jbp._pd_torque(cfg, pre.ptarget, states.torque_norm_last, gcT[7:].T,
                                 gvT[6:].T, tau_ff=tau_ff, pd_scale=pd_scale)
            out = jlanes.substep(P, gcT, gvT, tau.T, pre.base_wrench.T, cfg.contact_slip_vel,
                                 cfg.contact_impulse_mass / cfg.simulation_dt, cfg.simulation_dt)
            return out[:2], (tau,) + out[2:]
        (gcT, gvT), (taus, toes, toe_vels, fnorms, fns) = jax.lax.scan(
            substep, (pre.gc.T, pre.gv.T), None, length=cfg.substeps)
        diag = jdyn.StepDiagnostics(toe_pos=jnp.moveaxis(toes[-1], -1, 0),
                                    toe_vel=jnp.moveaxis(toe_vels[-1], -1, 0),
                                    toe_force_norm=fnorms[-1].T, toe_normal_force=fns[-1].T,
                                    torque=taus[-1])
        return jax.vmap(lambda s, k1, k2, k3, k4, g, v, t, d, p: jbp._post_substeps(
            cfg, s, (k1, k2, k3, k4), g, v, t, d, p, None))(
            states, key, k_cmd, k_obs, k_reset, gcT.T, gvT.T, taus[-1], diag, pre)

    def scan_fn(states, _):
        state = jax.tree.map(lambda x: x[0], states)
        prob = jsrb.make_problem(cfg, state.gc, state.gv, command, state.current_time)
        res = jsrb.solve(cfg, scfg, prob)
        sm0 = jsrb.stance_mask(cfg, state.current_time)
        tau_ff, pd_scale = jsrb.grf_to_torque(cfg, state.gc, res.forces[0], sm0, stance_pd,
                                              swing_pd)
        xy_shift = scfg.raibert_gain * (prob.v_meas - command[:2])
        q_ref = jgait.gait_reference(cfg, jsrb.sweep_command(cfg, scfg, prob),
                                     state.current_time, xy_shift, scfg.touchdown_match).joint_ref
        st = state._replace(command=command, command_filtered=command)
        out = step(jax.tree.map(lambda x: x[None], st), jnp.clip(q_ref - stand, -1.0, 1.0)[None],
                   tau_ff[None], pd_scale[None])
        return out.state, (out.state.gc[0], out.state.gv[0], res.cost)

    state = jbp.env_init(cfg, jax.random.PRNGKey(0))._replace(command=command,
                                                             command_filtered=command)
    run = jax.jit(lambda s: jax.lax.scan(scan_fn, s, None, length=n_steps)[1])
    return jax.tree.map(np.asarray, run(jax.tree.map(lambda x: x[None], state)))


def lanes_reference(n_steps: int, commands=(1.0, 2.0, 3.0, 4.0, 5.0)) -> dict:
    """The second reference of chip_smoke.py's closed-loop phase: each
    command's mean body-frame forward velocity over the trailing 40 % of
    ``n_steps``, unrounded, with the JAX loop stepped through the JAX
    package's lanes physics, the path the port's loop takes."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
    out = {}
    for vx in commands:
        env, scfg, _ = jruntime.speed_schedule(jconfig.test_default(), vx)
        gc, gv, _ = _jax_lanes_rollout(env, scfg, jnp.array([vx, 0.0, 0.0]), n_steps)
        v = np.asarray(jev.body_velocity(SimpleNamespace(gc=gc, gv=gv)))[:, 0]
        out[vx] = float(v[int(n_steps * 0.6):].mean())
    return out


def divergence_report(vx: float, n_steps: int) -> None:
    """Where the port's closed loop at command vx leaves the JAX package's on
    the CPU: the port (plain physics) against JAX's mpc_rollout (per-env
    physics) and against the same loop through JAX's lanes physics. Prints
    the first step at which gc, the plan's cost and the forward speed part,
    and each loop's speed over the trailing 40 % and in 200-step windows."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
    cmd = jnp.array([vx, 0.0, 0.0])
    jenv, jscfg, kw = jruntime.speed_schedule(jconfig.test_default(), vx)
    per_env = jruntime.mpc_rollout(jenv, jscfg, cmd, jax.random.PRNGKey(0), n_steps, **kw)
    runs = {"JAX per-env": (np.asarray(per_env.gc), np.asarray(per_env.gv),
                            np.asarray(per_env.solve_cost)),
            "JAX lanes": _jax_lanes_rollout(jenv, jscfg, cmd, n_steps)}
    tenv, tscfg, kw = truntime.speed_schedule(tconfig.test_default(), vx)
    port = truntime.mpc_rollout(tenv, tscfg, np.array([vx, 0.0, 0.0], np.float32),
                                torch.Generator(), n_steps, device="cpu", **kw)
    runs["port"] = (port.gc.numpy(), port.gv.numpy(), port.solve_cost.numpy())
    speed = {k: np.asarray(jev.body_velocity(SimpleNamespace(gc=gc, gv=gv)))[:, 0]
             for k, (gc, gv, _) in runs.items()}

    def first(x, limit):
        hit = np.nonzero(x > limit)[0]
        return int(hit[0]) if len(hit) else None
    gc_p, _, cost_p = runs["port"]
    for name in ("JAX per-env", "JAX lanes"):
        gc, _, cost = runs[name]
        dgc = np.abs(gc_p - gc).max(axis=1)
        dcost = np.abs(cost_p - cost) / np.abs(cost)
        dv = np.abs(speed["port"] - speed[name])
        print(f"port vs {name}: first step with cost > 1e-4 relative {first(dcost, 1e-4)}, "
              f"gc > 1e-4 {first(dgc, 1e-4)}, > 1e-3 {first(dgc, 1e-3)}, > 1e-2 "
              f"{first(dgc, 1e-2)}, forward speed > 0.01 m/s {first(dv, 0.01)}, > 0.1 "
              f"{first(dv, 0.1)}; gc differs by {dgc[min(50, n_steps - 1)]:.2g} at step 50")
    dgc = np.abs(runs["JAX lanes"][0] - runs["JAX per-env"][0]).max(axis=1)
    print(f"JAX lanes vs JAX per-env: gc > 1e-3 first at step {first(dgc, 1e-3)}")
    for name, v in speed.items():
        windows = [round(float(v[i:i + 200].mean()), 3) for i in range(0, n_steps, 200)]
        print(f"{name}: {v[int(n_steps * 0.6):].mean():.4f} m/s over the last 40 %; "
              f"by 200 steps {windows}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_mpc.py 2500
    # JAX_PLATFORMS=cpu python tests/test_torch_mpc.py lanes 2500 [1,2,3,4,5]
    # JAX_PLATFORMS=cpu python tests/test_torch_mpc.py divergence 3 2000
    import sys
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "divergence":
        divergence_report(float(sys.argv[2]), int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1] == "lanes":
        cmds = [float(c) for c in (sys.argv[3] if len(sys.argv) > 3 else "1,2,3,4,5").split(",")]
        print("JAX_MPC_LANES_V =", lanes_reference(int(sys.argv[2]), cmds))
        sys.exit(0)
    print("JAX_MPC_V_FALLS =", closed_loop_reference(int(sys.argv[1])))
    r = jparity.srb_vs_bp5(jconfig.test_default(), jio.load_bp5_csv(ARTIFACT), 1.0)
    print("JAX_SRB_VS_BP5 =", {k: r[k] for k in ("mae", "mae_stance", "mae_swing")})
