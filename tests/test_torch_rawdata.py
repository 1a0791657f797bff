"""PyTorch port: the reference's recorded-data readers (``analysis/rawdata``)
against the JAX package's. The recordings are not in the repo (JAX's
``tests/test_rawdata.py`` skips its own), so a body-center stream and its
Param sidecar are written here in the format, from a seeded generator."""

import numpy as np
import pytest
import yaml

from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import rawdata as traw
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import rawdata as jraw

PROPS = ("pos", "quat", "vel_body", "omega_body", "z_axis", "posture", "vel_formatted",
         "omega_formatted", "posture_formatted")


def _stream(tmp_path, n_episodes=3, frames=40, skip=2, n_env=4, seg_len=25):
    """A body-center stream: records [x y z quat vel omega], written in
    segments of ``seg_len`` records as 13 rows each (Figure3.py:17-60)."""
    rng = np.random.default_rng(0)
    total = n_episodes * (frames // skip) * n_env
    rec = rng.normal(size=(total, 13)).astype(np.float32)
    rec[:, 2] = 0.28 + 0.01 * rec[:, 2]
    rec[:, 3:7] /= np.linalg.norm(rec[:, 3:7], axis=1, keepdims=True)
    raw = np.concatenate([rec[h:h + seg_len].T.ravel() for h in range(0, total, seg_len)])
    bin_file, param = tmp_path / "body-center.bin", tmp_path / "Param.txt"
    raw.astype(np.float32).tofile(bin_file)
    param.write_text(yaml.safe_dump({"seg_len": seg_len, "NoE": n_episodes, "FoE": frames,
                                     "Num_Of_Env": n_env, "skip_frame": skip, "z_noise": 0.01,
                                     "pitch_dot_noise": 0.2}))
    return str(bin_file), str(param), rec


@pytest.mark.parametrize("seg_len", [25, 7, 1000])
def test_body_center_stream_matches_jax(tmp_path, seg_len):
    bin_file, param, rec = _stream(tmp_path, seg_len=seg_len)
    got, want = traw.RobotBodyInfo(bin_file, param), jraw.RobotBodyInfo(bin_file, param)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data, rec.astype(np.float64))
    for name in PROPS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.episodes(), want.episodes())
    np.testing.assert_array_equal(got.noise, want.noise)
    assert got.noise.tolist() == [0.01, 0.0, 0.0, 0.0, 0.0, 0.2]
    assert got.episodes().shape == (3 * 4, 20, 13)
    assert got.vel_formatted.shape == (4, 20, 3, 3)
    assert (got.n_episodes, got.frames_per_episode, got.n_env, got.skip) == (3, 40, 4, 2)


def test_info_csv_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    T = 16
    gc, gv = rng.normal(size=(T, 19)), rng.normal(size=(T, 18))
    tau, contact = 10 * rng.normal(size=(T, 12)), (rng.random((T, 4)) > 0.5).astype(float)
    p = str(tmp_path / "info.csv")
    traw.dump_robot_info(p, gc, gv, tau, contact)
    got, want = traw.RobotInfo(p), jraw.RobotInfo(p)
    for name in ("z", "quat", "vel", "omega", "q", "dq", "tau", "contact", "vel_body"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
