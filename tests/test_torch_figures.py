"""PyTorch port: ``analysis/figures`` against the JAX package.

Each figure function of the port, drawn from the same numpy inputs as the
JAX package's, writes the same file byte for byte (one matplotlib, one
Pillow); the rollout animation, whose forward kinematics is each package's
own, within 5 % in size.
"""

import numpy as np
import pytest

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as tev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import figures as tfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape as tls
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import figures as jfig


def _numpy_log(T=120):
    rng = np.random.default_rng(1)
    gc = np.zeros((T, 19), np.float32)
    gc[:, 2], gc[:, 3] = 0.3, 1.0
    gc[:, 7:19] = np.tile([0.0, 0.8, -1.6] * 4, (T, 1)) + 0.1 * np.sin(np.arange(T) * 0.2)[:, None]
    z = lambda *s: np.zeros((T,) + s, np.float32)  # noqa: E731
    return tev.RolloutLog(gc=gc, gv=rng.normal(size=(T, 18)).astype(np.float32), torque=z(12),
                          action=z(12), obs=z(35), reward=z(), done=z(), contact=z(4),
                          command=z(3), lstm_state=rng.normal(size=(T, 384)).astype(np.float32),
                          joint_ref=gc[:, 7:19] + 0.05)


def _figure_args(name, cfg):
    rng = np.random.default_rng(2)
    log = _numpy_log()
    rows = [{"command": c, "v_mean": c * 0.95, "err_std": 0.05, "tcot": 0.3 + 0.1 * c,
             "latency_ms": 2.0 * c, "kappa": -3.0 + c / 5, "kappa_err": 0.1, "v_err": 0.02,
             "survived": c < 4, "kick": 1.0} for c in (1.0, 2.0, 3.0, 4.0)]
    w = tls.simplex_grid(0.1)
    terms = np.abs(rng.normal(size=(len(w), 8)))
    t = np.arange(60) * 0.01
    spec = tev.spectrogram(np.sin(2 * np.pi * 12.5 * np.arange(600) * 0.002), 0.002)
    pca = {"coords": rng.normal(size=(100, 2)), "value": rng.normal(size=100),
           "explained": np.array([0.6, 0.2])}
    return {
        "velocity_tracking_figure": (rows,),
        "tcot_figure": (rows,),
        "work_condition_figure": ({"speed": np.abs(rng.normal(size=(50, 12))) * 10,
                                   "torque": np.abs(rng.normal(size=(50, 12))) * 5}, cfg),
        "recorded_velocity_figure": (rng.normal(size=(200, 3)), 0.002),
        "latency_figure": (rows,),
        "tracking_panels_figure": ({1.0: log, 2.0: log}, 0.002),
        "kappa_latency_figure": (rows,),
        "poincare_figure": ({"0 ms": rng.normal(size=30), "4 ms": rng.normal(size=30)},),
        "tcot_grouped_figure": ({"a": rows[:2], "b": rows[2:]},),
        "recovery_figure": (rows,),
        "ternary_landscape_figure": ({"w": w, "terms": terms, "alive_len": np.full(len(w), 750.0)},
                                     tls.composites(cfg, terms)),
        "gait_bar": (cfg,),
        "rollout_animation": (log,),
        "pca_value_figure": (pca,),
        "spectrogram_figure": (spec,),
        "joint_traces_figure": (log, 0.002),
        "ee_traj_figure": (np.stack([np.sin(t), np.zeros_like(t), np.cos(t) - 1.3], -1)[:, None]
                           .repeat(4, 1), ),
    }[name]


FIGURES = ["velocity_tracking_figure", "tcot_figure", "work_condition_figure",
           "recorded_velocity_figure", "latency_figure", "tracking_panels_figure",
           "kappa_latency_figure", "poincare_figure", "tcot_grouped_figure", "recovery_figure",
           "ternary_landscape_figure", "gait_bar", "rollout_animation", "pca_value_figure",
           "spectrogram_figure", "joint_traces_figure", "ee_traj_figure"]


@pytest.mark.parametrize("name", FIGURES)
def test_figure_renders_as_jax_does(name, tmp_path):
    jcfg, tcfg = jconfig.test_default(), tconfig.test_default()
    ext = ".gif" if name == "rollout_animation" else ".png"
    t = np.arange(60) * 0.01
    kw = {"ee_traj_figure": {"skip": 5},
          "kappa_latency_figure": {"entropy_curves": {"1 m/s": (t, np.exp(-t), np.exp(-t) + 0.01)}},
          }.get(name, {})
    getattr(jfig, name)(*_figure_args(name, jcfg), str(tmp_path / f"jax{ext}"), **kw)
    getattr(tfig, name)(*_figure_args(name, tcfg), str(tmp_path / f"port{ext}"), **kw)
    got, want = (tmp_path / f"port{ext}").read_bytes(), (tmp_path / f"jax{ext}").read_bytes()
    assert len(got) > 1000
    if name == "rollout_animation":
        # the forward kinematics of two packages, float32 in another order
        assert abs(len(got) - len(want)) < 0.05 * len(want)
    else:
        assert got == want
