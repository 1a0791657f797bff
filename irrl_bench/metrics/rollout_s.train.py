"""Seconds of an update's rollout (``algo/ppo.rollout``'s collection loop,
its ``time_rollout_s``, the device synchronized around it), mean over the
window's updates."""

from irrl_bench.core import readings

LAYER, SOURCE, MOVES = "rollout: algo/ppo.rollout", "program_span", "train_env_steps_per_s"


def read(obs):
    return readings.mean(u["time_rollout_s"] for u in obs["layers"].get("update_times", []))
