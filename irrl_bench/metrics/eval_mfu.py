"""The whole control step's share of the float32 peak: the frozen
operations of a rollout (both towers and heads, ``counts/lstm.py``, and the
physics control step, ``counts/phys.py``, each env and step) times the
window's rollouts, over the window's seconds."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "whole step", "host_clock", "eval_env_steps_per_s"


def read(obs):
    return readings.mfu(obs)
