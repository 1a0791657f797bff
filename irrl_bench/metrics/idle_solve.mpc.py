"""The device's idle time while the host's innermost open span was
``srb.solve``, over the profiled rollout's wall, in %."""

from irrl_bench.core import spans

LAYER, SOURCE, MOVES = "MPC solver: mpc/srb.solve", "program_span", "mpc_robot_steps_per_s"


def read(obs):
    return spans.idle_share_under(obs, "mpc.rollout", "srb.solve")
