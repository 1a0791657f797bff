"""Run-provenance helper (ConfigurationSaver parity, raisim_gym_helper.py:6-18).

Port of ``utils/run_dir.py``. Creates a timestamped run directory and
snapshots the config + this package's env source file into it, so every
training run records exactly what it ran: the same contract as the
reference's ConfigurationSaver (run_bp_v5.py:214-216), which copied
Environment.hpp + the YAML.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil

from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig


def make_run_dir(log_root: str, cfg: EnvConfig, extra_files=()) -> str:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    run_dir = os.path.join(log_root, stamp)
    n = 1
    while os.path.exists(run_dir):   # two runs within one second
        n += 1
        run_dir = os.path.join(log_root, f"{stamp}-{n}")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.txt"), "w") as f:
        for field in dataclasses.fields(cfg):
            f.write(f"{field.name}: {getattr(cfg, field.name)}\n")
    env_src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "envs", "blackpanther.py")
    shutil.copy(env_src, run_dir)
    for f_ in extra_files:
        if os.path.exists(f_):
            shutil.copy(f_, run_dir)
    return run_dir
