"""Milliseconds a call of the MPC solve (``mpc/srb.solve``, one a control
step), the device synchronized around each call, over the traced window."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "MPC solver: mpc/srb.solve", "program_span", "mpc_robot_steps_per_s"


def read(obs):
    return readings.site_ms_per_call(obs, "solve")
