"""The 95th percentile of the traced window's control steps' synchronized
wall times (from one step's ``make_problem`` to the next's, the last to the
rollout's end), in ms: the tail a real-time controller feels. Every step of
every rollout of the window counts; with 250 steps a rollout a window holds
some thousands."""

import statistics

LAYER = "MPC loop: mpc/runtime.mpc_rollout"
SOURCE, MOVES = "program_span", "mpc_robot_steps_per_s"


def read(obs):
    walls = obs["layers"].get("step_walls", [])
    if len(walls) < 200:
        return None
    return 1e3 * statistics.quantiles(walls, n=20)[-1]
