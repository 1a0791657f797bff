"""The readers of the env step's post-physics graph counters
(``post_graph_replays_per_step.{train,mpc}``), on the synthetic traced runs
of ``test_bench_spans.py``, and with nothing recorded."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_bench_spans import _metric, _mpc_obs, _train_obs  # noqa: E402


def test_graph_replay_readers_on_synthetic_runs():
    """A replay a step under env.post in training; in the MPC loop a capture
    at the second step and a replay at every later one; a program that
    counts no graph reads None, though it records spans."""
    obs = _train_obs()
    rec = obs["spans"]
    posts = [i for i, s in enumerate(rec["spans"]) if s[0] == "env.post"]
    rec["counts"] += [("post_graph_replays", i, rec["spans"][i][2], 1) for i in posts]
    assert _metric("post_graph_replays_per_step.train").read(obs) == pytest.approx(1.0)
    assert _metric("post_graph_replays_per_step.train").read(_train_obs()) is None
    obs, _ = _mpc_obs()
    rec = obs["spans"]
    steps = [i for i, s in enumerate(rec["spans"]) if s[0] == "mpc.step"]
    rec["counts"] += [("post_graph_captures", steps[1], 1, 1)]
    rec["counts"] += [("post_graph_replays", i, k, 1) for k, i in enumerate(steps) if k >= 2]
    assert _metric("post_graph_replays_per_step.mpc").read(obs) == pytest.approx(248 / 250)
    assert _metric("post_graph_replays_per_step.mpc").read(_mpc_obs()[0]) is None


@pytest.mark.parametrize("name", ["post_graph_replays_per_step.train",
                                  "post_graph_replays_per_step.mpc"])
def test_graph_replay_readers_return_none_with_nothing_recorded(name):
    mod = _metric(name)
    assert mod.read({"profile": None}) is None
    assert mod.read({"profile": {"events": []}, "spans": None}) is None
    from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling
    profiling.take()
    assert mod.read({"profile": {"events": []}}) is None
