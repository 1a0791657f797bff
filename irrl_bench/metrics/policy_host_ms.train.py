"""Host milliseconds a rollout step spends in the policy (the program's
``ppo.policy`` span: ``models/lstm.forward``, ``sample``, ``neglogp``), over
the profiled update's control steps."""

from irrl_bench.core import spans

LAYER = "policy: models/lstm.forward, models/lstm.sample"
SOURCE, MOVES = "program_span", "train_env_steps_per_s"


def read(obs):
    return spans.host_ms_per_step(obs, "ppo.update", "ppo.policy")
