"""Replays of the env step's post-physics CUDA graph a control step of the
MPC loop (the program's ``post_graph_replays`` counter), over the profiled
rollout's steps: a fresh fleet's first two steps are the warm-up and the
capture, so 248 of 250 at most. None from a program that counts no graph."""

from irrl_bench.core import spans

LAYER = "env step: envs/blackpanther.step_batch"
SOURCE, MOVES = "program_counter", "mpc_robot_steps_per_s"


def read(obs):
    rec = spans.recorded(obs)
    if rec is None or not any(c[0].startswith("post_graph_") for c in rec["counts"]):
        return None
    return spans.count_per_step(obs, "mpc.rollout", "post_graph_replays")
