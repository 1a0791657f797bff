"""The whole control step's share of the float32 peak: the frozen
operations of a rollout (the Riccati sweep's knots, ``counts/srb.py``, and
the physics control step with its torque inputs, ``counts/phys.py``, each
robot and step) times the window's rollouts, over the window's seconds."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "whole step", "host_clock", "mpc_robot_steps_per_s"


def read(obs):
    return readings.mfu(obs)
