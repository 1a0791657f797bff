"""Replays of the env step's post-physics CUDA graph a rollout step (the
program's ``post_graph_replays`` counter, ``envs/post_graph``), over the
profiled update's control steps: 1 when every step replays the graph the
warm-up captured. None from a program that counts no graph at all."""

from irrl_bench.core import spans

LAYER = "env step: envs/blackpanther.step_batch"
SOURCE, MOVES = "program_counter", "train_env_steps_per_s"


def read(obs):
    rec = spans.recorded(obs)
    if rec is None or not any(c[0].startswith("post_graph_") for c in rec["counts"]):
        return None
    return spans.count_per_step(obs, "ppo.update", "post_graph_replays")
