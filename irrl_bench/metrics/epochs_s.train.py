"""Seconds of an update's epochs (``algo/ppo.train_epochs`` through
``models/lstm.sequence``, its ``time_epochs_s``), mean over the window's
updates."""

from irrl_bench.core import readings

LAYER = "learner: algo/ppo.train_epochs, models/lstm.sequence"
SOURCE, MOVES = "program_span", "train_env_steps_per_s"


def read(obs):
    return readings.mean(u["time_epochs_s"] for u in obs["layers"].get("update_times", []))
