"""Copies of host data to the card a rollout step (the program's
``host_copies`` counter: ``device.tensor`` and the leg flags of
``robot/kinematics``), over the profiled update's control steps."""

from irrl_bench.core import spans

LAYER = "host dispatch: envs/blackpanther.step_batch, models/lstm"
SOURCE, MOVES = "program_counter", "train_env_steps_per_s"


def read(obs):
    return spans.count_per_step(obs, "ppo.update", "host_copies")
