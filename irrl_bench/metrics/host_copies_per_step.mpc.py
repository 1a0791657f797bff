"""Copies of host data to the card a control step of the MPC loop (the
program's ``host_copies`` counter), over the profiled rollout's steps."""

from irrl_bench.core import spans

LAYER = ("MPC host dispatch: mpc/runtime.mpc_rollout, mpc/srb.solve, "
         "envs/blackpanther.step_batch")
SOURCE, MOVES = "program_counter", "mpc_robot_steps_per_s"


def read(obs):
    return spans.count_per_step(obs, "mpc.rollout", "host_copies")
