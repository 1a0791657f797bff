"""The whole update's share of the float32 peak (67 TFLOP/s): the frozen
operations of an update (``counts/lstm.update_ops``: the rollout's policy
and physics steps, each epoch's forward, backward and Adam) times the
window's updates, over the window's seconds."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "whole step", "host_clock", "train_env_steps_per_s"


def read(obs):
    return readings.mfu(obs)
