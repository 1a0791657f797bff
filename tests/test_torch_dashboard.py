"""PyTorch port: the training-curve dashboard (``analysis/dashboard``) and its
render at the end of ``cli.train``, against the JAX package (mirrors JAX's
``tests/test_dashboard.py``)."""

import os

import numpy as np
import pytest

from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import dashboard as tdash
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import train as tcli_train
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.metrics import JsonlLogger
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import dashboard as jdash

LOG = ("run dir: runs/x\n"
       "update 1/100: approxkl=0.005032 clipfrac=0.05703 entropy=-5.612 ep_count=1 "
       "ep_len_mean=340 ep_rew_mean=86.29 explained_variance=0.9011 loss=1.807 "
       "pg_loss=-0.0009283 reward_per_step=0.6655 vf_loss=3.615 fps=3.196e+04 "
       "timesteps=1.502e+08\n"
       "garbage line\n"
       "update 2/100: approxkl=0.004 clipfrac=0.047 entropy=-5.6 ep_count=0 ep_len_mean=0 "
       "ep_rew_mean=0 explained_variance=0.885 loss=1.85 pg_loss=-0.002 reward_per_step=0.666 "
       "vf_loss=3.7 fps=3.2e+04 timesteps=1.503e+08\n"
       "update 3: loss=+1.5e-3 fps=7\n")


def _rows(n=20):
    """JAX's test rows (test_dashboard.py:14-28)."""
    return [{"loss": 2.0 / (i + 1), "vf_loss": 1.0 / (i + 1), "pg_loss": -0.01 * i,
             "entropy": 17.0 - 0.1 * i, "approxkl": 0.005, "clipfrac": 0.05,
             "explained_variance": min(0.95, 0.1 * i), "reward_per_step": 0.3 + 0.01 * i,
             "ep_rew_mean": 50.0 + i if i % 3 == 0 else 0.0,
             "ep_len_mean": 300.0 if i % 3 == 0 else 0.0, "ep_count": 2 if i % 3 == 0 else 0,
             "fps": 4e4, "timesteps": (i + 1) * 150_000} for i in range(n)]


def test_parse_train_log_matches_jax(tmp_path):
    path = str(tmp_path / "train.log")
    with open(path, "w") as f:
        f.write(LOG)
    got = tdash.parse_train_log(path)
    assert got == jdash.parse_train_log(path)
    assert [r["update"] for r in got] == [1, 2, 3] and got[0]["fps"] == pytest.approx(3.196e4)
    assert got == tdash.load_metrics(path)


def test_load_metrics_matches_jax(tmp_path):
    with JsonlLogger(str(tmp_path / "metrics.jsonl")) as log:
        for r in _rows(5):
            log.write(r)
    for source in (str(tmp_path), str(tmp_path / "metrics.jsonl")):
        got = tdash.load_metrics(source)
        assert got == jdash.load_metrics(source) and len(got) == 5
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no metrics.jsonl"):
        tdash.load_metrics(str(empty))


@pytest.mark.parametrize("rows", ["jsonl", "log"])
def test_dashboard_png_and_html(tmp_path, rows):
    if rows == "log":
        path = str(tmp_path / "train.log")
        with open(path, "w") as f:
            f.write(LOG)
        data = tdash.parse_train_log(path)
    else:
        data = _rows()
    png, html = str(tmp_path / "dash.png"), str(tmp_path / "dash.html")
    assert tdash.training_dashboard(data, png, title="t") == png
    tdash.training_dashboard(data, html)
    assert os.path.getsize(png) > 10_000
    text = open(html).read()
    assert "data:image/png;base64," in text and "http" not in text
    with pytest.raises(ValueError, match="no metric rows"):
        tdash.training_dashboard([], png)


def test_main_writes_beside_the_source(tmp_path, capsys):
    with JsonlLogger(str(tmp_path / "metrics.jsonl")) as log:
        for r in _rows(4):
            log.write(r)
    out = tdash.main([str(tmp_path)])
    assert out == os.path.join(str(tmp_path), "dashboard.png") and os.path.getsize(out) > 10_000
    assert "4 updates" in capsys.readouterr().out


def test_cli_train_renders_the_dashboard(tmp_path):
    """JAX cli/train.py:159-165: the run dir gets dashboard.png beside
    metrics.jsonl."""
    run = tcli_train.main(["--device", "cpu", "--num-envs", "4", "--n-steps", "8",
                           "--max-updates", "2", "--log-dir", str(tmp_path)])
    png = os.path.join(run, "dashboard.png")
    assert os.path.getsize(png) > 10_000
    rows = tdash.load_metrics(run)
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
