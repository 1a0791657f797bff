"""PyTorch port: the analysis modes of ``cli/test.py`` against the JAX package.

- the Euler and axis-angle helpers of ``utils/rotation`` (1e-6), the delay
  FIFO and the low-pass filter (exactly);
- the pure post-processing functions fed identical arrays: ``value_pca``,
  ``spectrogram``, ``fit_kappa``, ``ensemble_entropy``, ``fit_entropy_kappa``,
  ``composites`` (1e-5) and ``save_total_reward`` (byte for byte);
- the rollout-based functions of ``analysis/eval`` on one 40-step flagship
  rollout at 2 m/s (the port's ``step_batch`` path, plain on the CPU, against
  JAX's per-env path), and ``latency_sweep`` on a 12-step rollout through a
  2-step observation FIFO. The port's rollout runs once: the port's
  ``policy_rollout`` is memoized for the module (a rollout of the plain
  physics is ~1 s a control step on the CPU); JAX's functions run their own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as tev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape as tls
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import robustness as trb
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import delay as tdelay
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import filters as tfilters
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import rotation as trot
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import landscape as jls
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import robustness as jrb
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import delay as jdelay
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import filters as jfilters
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import rotation as jrot

torch.set_num_threads(1)

ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
VX = 2.0
T = 40        # the flagship rollout of the eval functions
SKIP = 10     # their steady-state skip at this length (the defaults assume 750 steps)
# the trajectory tolerances of tests/test_torch_eval.py (test_phys_lanes.py:99-100): the
# lanes physics against JAX's per-env dynamics, fed back through the policy
GC_TOL, GV_TOL = 1e-3, 5e-2
TAU_TOL = 40.0 * GC_TOL + 1.0 * GV_TOL   # the PD law's stiffness and damping on those


@pytest.fixture(scope="module")
def params():
    return jio.load_bp5_csv(ARTIFACT), tio.load_bp5_csv(ARTIFACT, device="cpu")


@pytest.fixture(scope="module")
def cfgs():
    return jconfig.test_default(), tconfig.test_default()


@pytest.fixture
def memo_rollout(monkeypatch):
    """The port's policy_rollout, run once a (command, steps, delay)."""
    cache, real = {}, tev.policy_rollout

    def rollout(cfg, params, command, gen, n_steps=750, delay_steps=0, device=None, **kw):
        key = (np.asarray(command).tobytes(), n_steps, delay_steps)
        if key not in cache:
            cache[key] = real(cfg, params, command, gen, n_steps, delay_steps, device, **kw)
        return cache[key]
    monkeypatch.setattr(tev, "policy_rollout", rollout)
    return cache


_CACHE: dict = {}


@pytest.fixture
def shared_rollouts(memo_rollout):
    """One memo shared by every test of the module."""
    memo_rollout.update(_CACHE)
    yield
    _CACHE.update(memo_rollout)


def _gen():
    return torch.Generator().manual_seed(10)


# --- helpers of utils ----------------------------------------------------------

@pytest.mark.parametrize("fn", ["quat_from_axis_angle", "qua2euler", "euler2qua"])
def test_rotation_helpers_match_jax(fn, rng):
    if fn == "quat_from_axis_angle":
        args = (rng.standard_normal((64, 3)), rng.uniform(-np.pi, np.pi, 64))
    elif fn == "qua2euler":
        q = rng.standard_normal((64, 4))
        args = (q / np.linalg.norm(q, axis=-1, keepdims=True),)
    else:
        args = (rng.uniform(-1.5, 1.5, (64, 3)),)
    args = tuple(a.astype(np.float32) for a in args)
    want = np.asarray(getattr(jrot, fn)(*(jnp.asarray(a) for a in args)))
    got = getattr(trot, fn)(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)   # float32 transcendental rounding


def test_delay_fifo_matches_jax(rng):
    xs = rng.standard_normal((7, 5)).astype(np.float32)
    fill = rng.standard_normal(5).astype(np.float32)
    js = jdelay.delay_init(0.004, 0.002, 5, jnp.asarray(fill))
    ts = tdelay.delay_init(0.004, 0.002, 5, torch.as_tensor(fill))
    for x in xs:
        js, jout = jdelay.delay_step(js, jnp.asarray(x))
        ts, tout = tdelay.delay_step(ts, torch.as_tensor(x))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tdelay.delay_init(0.0, 0.002, 3).buf.shape == (1, 3)


def test_lowpass_and_alpha_match_jax(rng):
    new, prev = rng.standard_normal((2, 16)).astype(np.float32)
    for keep in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(
            tfilters.lowpass(torch.as_tensor(new), torch.as_tensor(prev), keep).numpy(),
            np.asarray(jfilters.lowpass(jnp.asarray(new), jnp.asarray(prev), keep)))
    assert tfilters.alpha_from_freq(30.0, 0.002) == jfilters.alpha_from_freq(30.0, 0.002)


# --- post-processing on identical arrays -------------------------------------------

def test_value_pca_matches_jax(params, rng):
    jp, tp = params
    state = rng.standard_normal((50, 384)).astype(np.float32)
    jlog = jev.RolloutLog(*([None] * 9), lstm_state=jnp.asarray(state), joint_ref=None)
    tlog = tev.RolloutLog(*([None] * 9), lstm_state=torch.as_tensor(state), joint_ref=None)
    for tower in ("v", "pi"):
        want, got = jev.value_pca(jp, jlog, tower), tev.value_pca(tp, tlog, tower)
        for k in ("value", "explained"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
        # principal axes are defined up to sign
        sign = np.sign((got["coords"] * want["coords"]).sum(0))
        np.testing.assert_allclose(got["coords"] * sign, want["coords"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [40, 1000])
def test_spectrogram_matches_jax(n, rng):
    x = rng.standard_normal(n)
    want, got = jev.spectrogram(x, 0.002), tev.spectrogram(x, 0.002)
    for k in ("freqs", "times", "db"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_fit_kappa_matches_jax(rng):
    t = np.arange(1000) * 0.002
    v = np.concatenate([np.full(500, 1.0), 1.0 + 0.5 * np.exp(-5.0 * t[:500])])
    v = v + rng.normal(scale=1e-3, size=v.shape)
    for kw in ({}, {"settle": 20, "window": 300}):
        want, got = jrb.fit_kappa(v, 0.002, 500, **kw), trb.fit_kappa(v, 0.002, 500, **kw)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_ensemble_entropy_and_fit_match_jax(rng):
    scale = np.array([0.02, 0.25, 0.25, 1.0, 1.0, 1.0])
    frames = [rng.uniform(-1, 1, (256, 6)) * scale * np.exp(-0.3 * f) + [0.3, 0, 0, 0, 0, 0]
              for f in range(30)]
    ent_j = np.array([jrb.ensemble_entropy(f) for f in frames])
    ent_t = np.array([trb.ensemble_entropy(f) for f in frames])
    np.testing.assert_allclose(ent_t, ent_j, rtol=1e-5, atol=1e-5)
    t = np.arange(30) * 0.01
    want, got = jrb.fit_entropy_kappa(t, ent_j), trb.fit_entropy_kappa(t, ent_j)
    for k in ("kappa", "kappa_err", "a", "b", "c"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    x = np.linspace(-0.5, 2.5, 31)
    np.testing.assert_allclose(trb.piecewise_flat_linear_flat(x, 0.2, 3.0, 1.1, -2.0),
                               jrb.piecewise_flat_linear_flat(x, 0.2, 3.0, 1.1, -2.0),
                               rtol=1e-5, atol=1e-5)


def test_composites_and_total_reward_match_jax(cfgs, rng, tmp_path):
    jcfg, tcfg = cfgs
    res = {"w": jls.simplex_grid(0.1), "terms": rng.standard_normal((66, 8)) * 50.0,
           "alive_len": rng.integers(100, 751, 66).astype(np.float32)}
    want, got = jls.composites(jcfg, res["terms"]), tls.composites(tcfg, res["terms"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    jls.save_total_reward(str(tmp_path / "jax.txt"), jcfg, res)
    tls.save_total_reward(str(tmp_path / "port.txt"), tcfg, res)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


# --- the rollout-based functions -----------------------------------------------------

def _jkey():
    return jax.random.PRNGKey(10)


def test_torque_power_and_work_condition_match_jax(params, cfgs, shared_rollouts):
    (jp, tp), (jcfg, tcfg) = params, cfgs
    want = jev.torque_power(jcfg, jp, VX, _jkey(), T, skip=SKIP)
    got = tev.torque_power(tcfg, tp, VX, _gen(), T, skip=SKIP, device="cpu")
    np.testing.assert_allclose(got["torque"], want["torque"], atol=TAU_TOL)
    np.testing.assert_allclose(got["joint_vel"], want["joint_vel"], atol=GV_TOL)
    for k in ("mean_power", "tcot", "v_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2)
    want = jev.work_condition(jcfg, jp, VX, _jkey(), T, skip=SKIP)
    got = tev.work_condition(tcfg, tp, VX, _gen(), T, skip=SKIP, device="cpu")
    np.testing.assert_allclose(got["speed"], want["speed"], atol=GV_TOL)
    np.testing.assert_allclose(got["torque"], want["torque"], atol=TAU_TOL)
    # one motor sample at the envelope's edge may tip either way
    assert abs(got["violation_rate"] - want["violation_rate"]) <= 1.0 / want["torque"].size


def test_state_space_and_correlation_match_jax(params, cfgs, shared_rollouts):
    (jp, tp), (jcfg, tcfg) = params, cfgs
    want = jev.state_space(jcfg, jp, VX, _jkey(), T, skip=SKIP)
    got = tev.state_space(tcfg, tp, VX, _gen(), T, skip=SKIP, device="cpu")
    np.testing.assert_allclose(got["q"], want["q"], atol=GC_TOL)
    np.testing.assert_allclose(got["qd"], want["qd"], atol=GV_TOL)
    np.testing.assert_allclose(got["ref"], want["ref"], atol=GC_TOL)
    want = jev.lstm_state_correlation(jcfg, jp, VX, _jkey(), T, skip=SKIP)
    got = tev.lstm_state_correlation(tcfg, tp, VX, _gen(), T, skip=SKIP, device="cpu")
    assert got.shape == (384, 384)
    # units whose activity over the window is ~0 divide by (std + 1e-8): compare the rest
    h = tev.policy_rollout(tev._fixed_command_cfg(tcfg), tp, np.array([VX, 0.0, 0.0]), _gen(),
                           T, device="cpu").lstm_state.numpy()[SKIP:]
    live = h.std(0) > 1e-3
    np.testing.assert_allclose(got[np.ix_(live, live)], want[np.ix_(live, live)], atol=1e-2)


def test_toes_energy_pca_spectrogram_of_the_rollout_match_jax(params, cfgs, shared_rollouts):
    (jp, tp), (jcfg, tcfg) = params, cfgs
    jlog = jev.policy_rollout(jev._fixed_command_cfg(jcfg), jp, jnp.array([VX, 0.0, 0.0]),
                              _jkey(), T)
    tlog = tev.policy_rollout(tev._fixed_command_cfg(tcfg), tp, np.array([VX, 0.0, 0.0]),
                              _gen(), T, device="cpu")
    np.testing.assert_allclose(tev.toe_trajectories(tlog), jev.toe_trajectories(jlog),
                               atol=GC_TOL)
    want = jev.energy_data(jcfg, jp, VX, _jkey(), T)
    got = tev.energy_data(tcfg, tp, VX, _gen(), T, device="cpu")
    assert sorted(got) == sorted(want)
    for k, tol in (("gc", GC_TOL), ("gv", GV_TOL), ("torque", TAU_TOL), ("contact", 0.0)):
        np.testing.assert_allclose(got[k], want[k], atol=tol)
    # M^-1 and the nonlinearities of the dense model at states GC_TOL / GV_TOL apart
    np.testing.assert_allclose(got["inverse_mass"], want["inverse_mass"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["nonlinear"], want["nonlinear"], rtol=1e-3, atol=5e-2)
    np.testing.assert_allclose(got["power"], want["power"],
                               atol=TAU_TOL * 30.0 + 18.0 * GV_TOL)  # |qd| < 30, |tau| < 18
    res_j, res_t = jev.value_pca(jp, jlog), tev.value_pca(tp, tlog)
    np.testing.assert_allclose(res_t["value"], res_j["value"], atol=1e-2)
    knee_j = jev.spectrogram(np.asarray(jlog.gv)[:, 8], jcfg.control_dt)
    knee_t = tev.spectrogram(tlog.gv[:, 8].numpy(), tcfg.control_dt)
    np.testing.assert_allclose(knee_t["db"], knee_j["db"], atol=1.0)


def test_latency_sweep_matches_jax(params, cfgs, shared_rollouts):
    (jp, tp), (jcfg, tcfg) = params, cfgs
    want = jev.latency_sweep(jcfg, jp, VX, [2], _jkey(), 12, skip=4)
    got = tev.latency_sweep(tcfg, tp, VX, [2], _gen(), 12, skip=4, device="cpu")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert g["latency_ms"] == w["latency_ms"] and g["survival"] == w["survival"]
        np.testing.assert_allclose(g["v_mean"], w["v_mean"], atol=GV_TOL)
    # the FIFO itself: the port's delayed rollout against JAX's, step by step
    jlog = jev.policy_rollout(jev._fixed_command_cfg(jcfg), jp, jnp.array([VX, 0.0, 0.0]),
                              _jkey(), 12, delay_steps=2)
    tlog = tev.policy_rollout(tev._fixed_command_cfg(tcfg), tp, np.array([VX, 0.0, 0.0]),
                              _gen(), 12, delay_steps=2, device="cpu")
    np.testing.assert_allclose(tlog.action.numpy(), np.asarray(jlog.action), atol=5e-3)
    np.testing.assert_allclose(tlog.gc.numpy(), np.asarray(jlog.gc), atol=GC_TOL)

