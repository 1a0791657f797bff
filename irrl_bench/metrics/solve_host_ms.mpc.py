"""Host milliseconds a control step spends in the MPC solve (the program's
``srb.solve`` span, its factorization check's sync included), over the
profiled rollout's control steps, with no synchronization around it."""

from irrl_bench.core import spans

LAYER, SOURCE, MOVES = "MPC solver: mpc/srb.solve", "program_span", "mpc_robot_steps_per_s"


def read(obs):
    return spans.host_ms_per_step(obs, "mpc.rollout", "srb.solve")
