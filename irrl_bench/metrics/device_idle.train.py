"""The share of the profiled update in which no operation ran on the device."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "device", "device_trace", "train_env_steps_per_s"


def read(obs):
    return readings.idle_share(obs)
