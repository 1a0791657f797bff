"""PyTorch port: the vectorized environment API (envs/vec.py) against the JAX package.

The port's ``NumpyVecEnv`` is held against the JAX package's from the same
states (JAX's carried over) and actions, under the deployment config with
hard contact and the meteorite attacks, where no random draw reaches the
result: observations, rewards, dones, the info dicts with their episode
bookkeeping, every getter, and ``set_contact_coefficient``. Then seeding,
resets, commands, what is refused, a RefTraj table in both packages' VecEnv,
and the recorded video against the GIF JAX's writer makes of the same frames.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import vec as tvec
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import figures as jfigures
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import reftraj as jreftraj
from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import vec as jvec

torch.set_num_threads(1)

B, STEPS = 3, 4
OVER = dict(num_envs=B, hard_contact=True, crucial=True)
MATERIAL = (0.8, 0.2, 0.01)     # the reference's test-path material (run_bp_v5.py:317)
GETTERS = ("origin_state", "reference_state", "get_joint_effort", "get_generalized_force",
           "get_inverse_mass_matrix", "get_nonlinear", "get_sphere_info")


def _port_state(js) -> tbp.EnvState:
    """A batched JAX EnvState on flat ground as the port's."""
    js = jax.tree.map(np.asarray, js)
    kw = {name: torch.from_numpy(np.array(getattr(js, name)))
          for name in tbp.EnvState.__dataclass_fields__ if name not in ("params", "terrain")}
    return tbp.EnvState(params=tmdl.robot_params_from_numpy(js.params, "cpu"), terrain=None, **kw)


@pytest.fixture(scope="module")
def stepped():
    """Both adapters from JAX's start (toes in the ground, env 0 lifted out of
    the height limits after step 2 so that it ends an episode), stepped
    STEPS times with the same actions; the getters read after each step."""
    jenv = jvec.NumpyVecEnv(jconfig.test_default().replace(**OVER), seed=3)
    tenv = tvec.NumpyVecEnv(tconfig.test_default().replace(**OVER), seed=3, device="cpu")
    rng = np.random.default_rng(0)
    jenv.state = jenv.state._replace(gc=jenv.state.gc.at[:, 2].add(-0.075).at[:, 7:].add(
        jnp.asarray(0.1 * rng.normal(size=(B, 12)), jnp.float32)))
    jenv.set_contact_coefficient(MATERIAL)
    tenv.state = _port_state(jenv.state)
    rows = []
    for i in range(STEPS):
        if i == 2:
            jenv.state = jenv.state._replace(gc=jenv.state.gc.at[0, 2].set(0.9))
            gc = tenv.state.gc.clone()
            gc[0, 2] = 0.9
            tenv.state = tenv.state.replace(gc=gc)
        a = (0.3 * rng.normal(size=(B, 12))).astype(np.float32)
        rows.append((jenv.step(a), tenv.step(a),
                     {g: (getattr(jenv, g)(), getattr(tenv, g)()) for g in GETTERS}))
    return rows


def test_step_and_info_dicts_match_jax(stepped):
    ended = 0
    for i, ((jo, jr, jd, jinfo), (to, tr, td, tinfo), _) in enumerate(stepped):
        np.testing.assert_allclose(to, np.asarray(jo), atol=1e-5, err_msg=f"step {i} obs")
        np.testing.assert_allclose(tr, np.asarray(jr), atol=1e-5, err_msg=f"step {i} reward")
        np.testing.assert_array_equal(td, np.asarray(jd))
        assert [d.keys() for d in tinfo] == [d.keys() for d in jinfo]
        for t, j in zip(tinfo, jinfo):
            for k, v in j["extra_info"].items():
                np.testing.assert_allclose(t["extra_info"][k], v, atol=1e-5, err_msg=k)
            if "episode" in j:
                ended += 1
                assert t["episode"]["l"] == j["episode"]["l"]
                np.testing.assert_allclose(t["episode"]["r"], j["episode"]["r"], atol=1e-5)
    assert ended == 1, "the episode bookkeeping went untested"


def test_getters_match_jax(stepped):
    for i, (_, _, getters) in enumerate(stepped):
        for name, (want, got) in getters.items():
            assert got.shape == np.asarray(want).shape, name
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=(1e-4 if name == "get_inverse_mass_matrix" else 1e-5)
                                       * scale, err_msg=f"step {i} {name}")


def test_reset_and_episode_info_match_jax():
    jenv = jvec.NumpyVecEnv(jconfig.test_default().replace(num_envs=B), seed=1)
    tenv = tvec.NumpyVecEnv(tconfig.test_default().replace(num_envs=B), seed=1, device="cpu")
    for env in (jenv, tenv):
        env._ep_rewards[1].extend([0.5, 0.25])
    (jobs, jinfo), (tobs, tinfo) = jenv.reset_and_update_info(), tenv.reset_and_update_info()
    np.testing.assert_allclose(tobs, np.asarray(jobs), atol=1e-6)
    assert tinfo == jinfo and tinfo[1]["episode"] == {"r": 0.75, "l": 2}


def test_set_contact_coefficient_matches_jax():
    jenv = jvec.NumpyVecEnv(jconfig.test_default().replace(num_envs=B), seed=0)
    tenv = tvec.NumpyVecEnv(tconfig.test_default().replace(num_envs=B), seed=0, device="cpu")
    for coeff in (MATERIAL, (0.5, 0.0, 0.0), (1.0, 0.0015, 1.0)):
        jenv.set_contact_coefficient(coeff)
        tenv.set_contact_coefficient(coeff)
        for name in ("friction", "restitution", "res_threshold", "contact_damping",
                     "contact_stiffness"):
            np.testing.assert_allclose(getattr(tenv.state.params, name).numpy(),
                                       np.asarray(getattr(jenv.state.params, name)), rtol=1e-6,
                                       err_msg=f"{coeff} {name}")


def test_seed_reset_command_and_what_is_refused(tmp_path):
    cfg = tconfig.train_default().replace(num_envs=B)
    env = tvec.NumpyVecEnv(cfg, seed=5, device="cpu")
    first = env.origin_state()
    env.step(np.zeros((B, 12), np.float32))
    env.seed(5)
    np.testing.assert_array_equal(env.origin_state(), first)
    assert env.reset().shape == (B, 35) and env.observe().shape == (B, 35)
    env.set_command([2.0, 0.0, 0.5])
    np.testing.assert_array_equal(env.state.command_filtered.numpy(), [[2.0, 0.0, 0.5]] * B)
    with pytest.raises(ValueError, match="Flag_Crutial"):
        env.get_sphere_info()
    # a RefTraj table: both packages' VecEnv put every env's references on its rows
    table = np.asarray(jreftraj.synthesize(
        jconfig.train_default().replace(manual_traj=False), np.array([[1.0, 0.0, 0.0]]), 800))
    for mod, venv_cls in ((tconfig, lambda c: tvec.VecEnv(c, ref_table=table, device="cpu")),
                          (jconfig, lambda c: jvec.VecEnv(c, ref_table=table))):
        venv = venv_cls(mod.train_default().replace(num_envs=B, manual_traj=False))
        st = venv.init(3)
        st = venv.step(st, np.zeros((B, 12), np.float32) if mod is jconfig
                       else torch.zeros(B, 12)).state
        frame = np.asarray(st.frame_idx) - 1
        np.testing.assert_array_equal(np.asarray(st.joint_ref), table[frame, 0:12])
        np.testing.assert_array_equal(np.asarray(st.command_filtered), table[frame, 27:30])
    env.start_recording_video(str(tmp_path / "none.gif"))
    env.stop_recording_video()               # no frame recorded: nothing to render
    assert not (tmp_path / "none.gif").exists()
    # recorded frames render to a GIF as JAX's adapter renders them (figures.rollout_animation)
    gif = tmp_path / "v.gif"
    env.start_recording_video(str(gif))
    gcs = []
    for _ in range(12):
        env.step(np.zeros((B, 12), np.float32))
        gcs.append(env.state.gc[0].numpy().copy())
    env.stop_recording_video()
    want = tmp_path / "jax.gif"
    jfigures.rollout_animation(SimpleNamespace(gc=np.stack(gcs)), str(want))
    with Image.open(gif) as got_img, Image.open(want) as want_img:
        assert got_img.n_frames == want_img.n_frames == 2     # stride 10 over 12 frames
    assert abs(gif.stat().st_size - want.stat().st_size) < 0.05 * want.stat().st_size
    venv = tvec.VecEnv(cfg, device="cpu")
    s = venv.init(7)
    out = venv.step(s, torch.zeros(B, 12))
    assert out.obs.shape == (B, 35) and torch.equal(venv.observe(out.state), out.obs)
    assert torch.equal(venv.init(7).gc, s.gc)
