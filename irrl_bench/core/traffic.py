"""The one generator of every cell's traffic, driven by the parameters of
``traffic/<name>.json``.

A traffic file gives the batch (``num_envs`` robots or envs stepped as one
batch), the length of a unit (``n_steps`` control steps) and, for the
closed loops at fixed commands, each command component's uniform range
(``vx``, ``vy``, ``yaw_rate`` as [low, high]; equal bounds fix it). Every
command is drawn from the seed; a unit that starts a fresh fleet draws its
own commands from the seed and the unit's index.
"""

from __future__ import annotations

import numpy as np
import torch

COMMAND_KEYS = ("vx", "vy", "yaw_rate")


def commands(traffic: dict, seed: int, unit: int, device) -> torch.Tensor:
    """(num_envs, 3) commands of unit ``unit`` of the run of ``seed``."""
    rng = np.random.default_rng([seed, unit])
    n = int(traffic["num_envs"])
    cols = [rng.uniform(*traffic[k], size=n) for k in COMMAND_KEYS]
    return torch.tensor(np.stack(cols, axis=-1), dtype=torch.float32, device=device)


def picks(seed: int, n_steps: int, k: int) -> list[int]:
    """The ``k`` control steps of a unit whose calls the comparison records."""
    rng = np.random.default_rng([seed, 7919])
    return sorted(int(i) for i in rng.choice(n_steps, k, replace=False))
