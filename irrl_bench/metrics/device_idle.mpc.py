"""The share of the profiled rollout in which no operation ran on the device."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "device", "device_trace", "mpc_robot_steps_per_s"


def read(obs):
    return readings.idle_share(obs)
