"""PyTorch (aten) ops the host issues a control step of the evaluation
rollout (``envs/blackpanther.step_batch`` and ``models/lstm`` inference, the
rollout's log): a 16-step rollout's less an 8-step one's, over 8."""

LAYER = "host dispatch: envs/blackpanther.step_batch, models/lstm"
SOURCE, MOVES = "program_counter", "eval_env_steps_per_s"


def read(obs):
    return obs["ops"].get("rollout_step")
