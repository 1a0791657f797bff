"""PyTorch port: RefTraj tables (``envs/reftraj.py`` and the ``ref_table``
of ``envs/blackpanther``) against the JAX package.

``synthesize`` is held to JAX's table within 1e-5 and ``from_trot_csv`` on a
synthetic CSV in the 28-column layout within 1e-6 (the recorded
``Exp_Raw_Data/trot_ref_.csv`` is not in the repo). From JAX's ``env_init``
states (their frame indices carried over), the port's ``step`` and
``step_batch`` put the references, the filtered command and the phase
observation exactly on the table rows, as JAX's ``tests/test_reftraj.py``
asserts of its own, with obs and reward within the flat env test's
tolerances of JAX ``vmap(step)``; ``reset`` starts each env on a frame of the
table and puts the same fields on its rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import reftraj as tref
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import vec as tvec
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import reftraj as jref

torch.set_num_threads(1)

B = 4
CMDS = np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
FRAMES = 900


def _configs():
    """JAX's own RefTraj test config (test_reftraj.py:10-14), with no action
    noise so that no random draw reaches a step."""
    kw = dict(simulation_dt=0.001, obs_noise=0.0, action_noise=0.0, stochastic_dynamics=False,
              manual_traj=False, force_disturbance=False, num_envs=B)
    return jconfig.train_default().replace(**kw), tconfig.train_default().replace(**kw)


@pytest.fixture(scope="module")
def tables():
    jcfg, tcfg = _configs()
    return (np.asarray(jref.synthesize(jcfg, CMDS, frames_per_command=FRAMES)),
            tref.synthesize(tcfg, CMDS, FRAMES, device="cpu"))


def test_synthesize_matches_jax(tables):
    """Every column within 1e-5 of JAX's but theta_dot (12:24), a float32
    difference of successive theta over dt = 2 ms: there one ulp of theta
    (1.2e-7 to 2.4e-7, where XLA's and PyTorch's sin and cos part) reads as
    6e-5 to 1.2e-4, so theta_dot is held to be, on both sides, exactly that
    difference of each side's own theta (theta being within 1e-5 of JAX's)."""
    want, got = tables
    assert got.shape == (2 * FRAMES, tref.TABLE_COLS) == want.shape
    assert got.dtype == torch.float32
    t = got.numpy()
    dot = np.r_[12:24]
    rest = np.setdiff1d(np.arange(tref.TABLE_COLS), dot)
    np.testing.assert_allclose(t[:, rest], want[:, rest], atol=1e-5, rtol=0)
    dt = np.float32(_configs()[1].control_dt)
    for tab in (t, want):
        for seg in (slice(1, FRAMES), slice(FRAMES + 1, 2 * FRAMES)):
            rows = np.arange(2 * FRAMES)[seg]
            np.testing.assert_array_equal(tab[rows, 12:24],
                                          (tab[rows, 0:12] - tab[rows - 1, 0:12]) / dt)
    np.testing.assert_allclose(t[:, 25] ** 2 + t[:, 26] ** 2, 1.0, atol=1e-5)
    assert t[0, 27] == 1.0 and t[-1, 27] == 2.0


def test_from_trot_csv_matches_jax(tmp_path):
    """A synthetic table in the 28-column layout (x z pitch q0-11 dq0-11 roll)."""
    rng = np.random.default_rng(0)
    n = 300
    raw = rng.normal(size=(n, 28)).astype(np.float32)
    raw[:, 0] = np.arange(n) * 0.002 * 4.5          # a 4.5 m/s run
    path = str(tmp_path / "trot_ref_.csv")
    np.savetxt(path, raw, delimiter=",", fmt="%.8g")
    jcfg, tcfg = _configs()
    want = np.asarray(jref.from_trot_csv(path, jcfg))
    got = tref.from_trot_csv(path, tcfg, device="cpu")
    assert got.shape == (n, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert abs(float(got[0, 27]) - 4.5) < 1e-3
    np.testing.assert_allclose(tref.from_trot_csv(path, tcfg, vx_command=3.0,
                                                  device="cpu")[:, 27].numpy(), 3.0)
    np.savetxt(path, raw[:, :20], delimiter=",")
    with pytest.raises(ValueError, match="20 columns"):
        tref.from_trot_csv(path, tcfg, device="cpu")


def _state_from_jax(js) -> tbp.EnvState:
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


def _on_rows(state: tbp.EnvState, obs_double: torch.Tensor, table: torch.Tensor,
             frame: torch.Tensor) -> None:
    """References and filtered command (also the obs' first 3) on row
    ``frame`` - 1, the row the last reference update read."""
    row = table[(frame - 1).long()]
    assert torch.equal(state.joint_ref, row[:, 0:12])
    assert torch.equal(state.joint_dot_ref, row[:, 12:24])
    assert torch.equal(state.command_filtered, row[:, 27:30])
    assert torch.equal(obs_double[:, 0:3], row[:, 27:30])
    assert not state.ee_ref.any()


@pytest.mark.parametrize("path", ["step", "step_batch"])
def test_steps_put_references_on_the_table_rows_and_match_jax(tables, path):
    jcfg, tcfg = _configs()
    table = torch.from_numpy(tables[0].copy())    # JAX's table on both sides
    js = jax.vmap(lambda k: jbp.env_init(jcfg, k, jnp.asarray(tables[0])))(
        jax.random.split(jax.random.PRNGKey(0), B))
    ts = _state_from_jax(js)
    frame = ts.frame_idx.clone()
    assert (frame >= 1).all() and (frame < table.shape[0]).all()
    _on_rows(ts, ts.obs_double, table, frame)
    rng = np.random.default_rng(1)
    actions = (0.1 * rng.normal(size=(B, 12))).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda s, a: jbp.step(jcfg, s, a, jnp.asarray(tables[0]))))(
        js, jnp.asarray(actions))
    assert not np.asarray(ref.done).any()
    got = getattr(tbp, path)(tcfg, ts, torch.from_numpy(actions), torch.Generator(),
                             ref_table=table)
    assert not got.done.any()
    assert torch.equal(got.state.frame_idx, frame + 1)
    _on_rows(got.state, got.state.obs_double, table, frame + 1)
    # the phase observation is the row of the stepped frame (Environment.hpp:972)
    assert torch.equal(got.state.obs_double[:, 3:5], table[frame.long(), 25:27])
    np.testing.assert_array_equal(got.state.obs_double[:, 3:5].numpy(),
                                  np.asarray(ref.state.obs_double)[:, 3:5])
    # the flat env test's tolerances (test_torch_env.py)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), atol=2e-3)
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward), atol=2e-3)
    np.testing.assert_allclose(got.state.gc.numpy(), np.asarray(ref.state.gc), atol=1e-4)
    np.testing.assert_allclose(got.state.joint_ref.numpy(), np.asarray(ref.state.joint_ref),
                               atol=0)


def test_reset_starts_on_a_table_frame(tables):
    """Frames drawn with the reference's density reshaping from the start-time
    uniform, within [0, N - episode_len - 10]; every reference on its row."""
    _, tcfg = _configs()
    table = tables[1]
    s = tbp.env_init(tcfg, 256, torch.Generator().manual_seed(0), "cpu", ref_table=table)
    frame0 = s.frame_idx - 1
    span = table.shape[0] - tcfg.episode_len - 10
    assert frame0.min() >= 0 and frame0.max() <= span and len(frame0.unique()) > 100
    _on_rows(s, s.obs_double, table, s.frame_idx)
    assert torch.equal(s.obs_double[:, 3:5], table[frame0.long(), 25:27])
    # the frame follows the start time t0 = current_time - dt through the reshaping
    t0 = s.current_time - tcfg.control_dt
    want = torch.clamp_min((span * tbp._sampling_reshape(t0)).to(torch.int32), 0)
    assert (frame0 - want).abs().max() <= 1    # t0 + dt - dt rounds by an ulp
    # a table shorter than an episode starts every env at frame 0
    short = tbp.env_init(tcfg, 8, torch.Generator(), "cpu", ref_table=table[:100])
    assert (short.frame_idx == 1).all()
    # without a table, or with ManualTraj, the gait generator runs as before
    plain = tbp.env_init(tcfg.replace(manual_traj=True), 8, torch.Generator().manual_seed(0),
                         "cpu", ref_table=table)
    assert (plain.frame_idx == 1).all()


def test_vec_env_steps_a_table(tables):
    """VecEnv(cfg, ref_table) holds the table on its device and hands it to
    every init, step and reset; step_batch's one physics launch a step is
    untouched (its kernel count is held on the card)."""
    _, tcfg = _configs()
    env = tvec.VecEnv(tcfg, ref_table=tables[1].numpy(), device="cpu")
    assert env.ref_table.dtype == torch.float32 and env.ref_table.is_contiguous()
    s = env.init(3)
    out = env.step(s, torch.zeros(B, 12))
    _on_rows(out.state, out.state.obs_double, env.ref_table, s.frame_idx + 1)
    r = env.reset(out.state)
    _on_rows(r, r.obs_double, env.ref_table, r.frame_idx)

