"""The device's idle time while the host's innermost open span was
``env.step`` or one below it (``env.pre``, ``env.kernel``, ``env.post``,
``gait.reference``), over the profiled update's wall, in %."""

from irrl_bench.core import spans

LAYER = "env step: envs/blackpanther.step_batch"
SOURCE, MOVES = "program_span", "train_env_steps_per_s"


def read(obs):
    return spans.idle_share_under(obs, "ppo.update", "env.step")
