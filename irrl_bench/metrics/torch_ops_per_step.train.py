"""PyTorch (aten) ops the host issues a control step of the rollout, its
loop and GAE: the ops of a 16-step rollout less those of an 8-step one, over
8, counted by a TorchDispatchMode."""

LAYER = "host dispatch: envs/blackpanther.step_batch, models/lstm"
SOURCE, MOVES = "program_counter", "train_env_steps_per_s"


def read(obs):
    return obs["ops"].get("rollout_step")
