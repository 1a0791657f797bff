"""Milliseconds a call of the env step (``envs/blackpanther.step_batch``, one
a control step), the device synchronized around each call, over the traced
window."""

from irrl_bench.core import readings

LAYER = "env step: envs/blackpanther.step_batch"
SOURCE, MOVES = "program_span", "mpc_robot_steps_per_s"


def read(obs):
    return readings.site_ms_per_call(obs, "env_step")
