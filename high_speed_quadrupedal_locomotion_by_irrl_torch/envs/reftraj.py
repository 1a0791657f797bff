"""RefTraj table construction and interop.

Port of ``envs/reftraj.py``. The reference's RefTraj mode replays a
pre-recorded table (theta 0:12 | theta_dot 12:24 | z 24 | phase 25:27 |
cmd 27:30, the layout consumed at Environment.hpp:972, :1102, :1664-1682).
The training CSVs were never shipped (absolute home paths in the YAMLs;
VectorizedEnvironment tolerates their absence at :160-169), so this module
provides:

- :func:`synthesize`: a table from the port's own gait generator (a command
  schedule -> the exact 30-column layout);
- :func:`from_trot_csv`: the shipped 28-column analysis table
  (Exp_Raw_Data/trot_ref_.csv: x z pitch q0-11 dq0-11 roll) in the 30-column
  layout, its phase channel from the gait clock.

Both return an (N, 30) float32 tensor on ``device`` (default ``cuda``), the
``ref_table`` of :mod:`.blackpanther` and :class:`.vec.VecEnv`. Tables are
built on the host; CSV files load through the native runtime
(:func:`..utils.native.load_table`).
"""

from __future__ import annotations

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import native

TABLE_COLS = 30


def _joint_ref(cfg: EnvConfig, cmd: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """The gait generator's (len(ts), 12) joint references at command ``cmd``
    (3,) and float32 times ``ts``, on the CPU."""
    t = torch.as_tensor(np.asarray(ts, np.float32).reshape(-1))
    command = torch.as_tensor(np.asarray(cmd, np.float32)).expand(t.shape[0], 3)
    return gait.gait_reference(cfg, command, t).joint_ref.numpy()


def synthesize(cfg: EnvConfig, commands: np.ndarray, frames_per_command: int,
               device=None) -> torch.Tensor:
    """Build a (len(commands) * frames, 30) RefTraj table from the gait
    generator: commands (K, 3), each held for ``frames_per_command`` steps."""
    dt = cfg.control_dt
    rows = []
    t = 0.0
    for cmd in np.asarray(commands, dtype=np.float64):
        ts = t + np.arange(frames_per_command) * dt
        refs = _joint_ref(cfg, cmd, ts)
        prev = _joint_ref(cfg, cmd, np.array([t - dt]))
        dots = np.diff(np.vstack([prev, refs]), axis=0) / dt
        phase = np.stack([np.sin(2 * np.pi * ts / cfg.period),
                          np.cos(2 * np.pi * ts / cfg.period)], axis=-1)
        z = np.full((frames_per_command, 1), cfg.stand_height)
        cmds = np.tile(cmd, (frames_per_command, 1))
        rows.append(np.concatenate([refs, dots, z, phase, cmds], axis=-1))
        t = float(ts[-1] + dt)
    return dev_mod.tensor(np.concatenate(rows, axis=0).astype(np.float32),
                          dev_mod.resolve(device))


def from_trot_csv(path: str, cfg: EnvConfig, dt_record: float = 0.002,
                  vx_command: float | None = None, device=None) -> torch.Tensor:
    """Convert the shipped 28-column trot table into the 30-column RefTraj
    layout."""
    raw = native.load_table(path)          # (N, 28): x z pitch q12 dq12 roll
    if raw.shape[1] < 27:
        raise ValueError(f"{path}: {raw.shape[1]} columns, the trot table has 28")
    n = raw.shape[0]
    ts = np.arange(n) * dt_record
    phase = np.stack([np.sin(2 * np.pi * ts / cfg.period),
                      np.cos(2 * np.pi * ts / cfg.period)], axis=-1)
    if vx_command is None:
        # average forward speed from the x column
        vx_command = float((raw[-1, 0] - raw[0, 0]) / max(ts[-1], 1e-9))
    cmds = np.tile([vx_command, 0.0, 0.0], (n, 1)).astype(np.float32)
    table = np.concatenate([raw[:, 3:15], raw[:, 15:27], raw[:, 1:2],
                            phase.astype(np.float32), cmds], axis=-1)
    return dev_mod.tensor(table, dev_mod.resolve(device))
