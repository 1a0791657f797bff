"""The 95th percentile of the profiled rollout's control steps on the host
(the program's ``mpc.step`` spans less the benchmark's step clock before
each ``make_problem``), in ms; None under 200 steps."""

from irrl_bench.core import spans

LAYER = "MPC loop: mpc/runtime.mpc_rollout"
SOURCE, MOVES = "program_span", "mpc_robot_steps_per_s"


def read(obs):
    if spans.recorded(obs) is None:
        return None
    return spans.p95(spans.host_durations_ms(obs, "mpc.rollout", "mpc.step"))
