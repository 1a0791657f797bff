"""Host milliseconds a rollout step spends in the env step (the program's
``env.step`` span around ``envs/blackpanther.step_batch``), over the profiled
update's control steps."""

from irrl_bench.core import spans

LAYER = "env step: envs/blackpanther.step_batch"
SOURCE, MOVES = "program_span", "train_env_steps_per_s"


def read(obs):
    return spans.host_ms_per_step(obs, "ppo.update", "env.step")
