"""The reference's "info" CSV log format, in numpy only.

Port of ``analysis/rawdata.RobotInfo`` and ``dump_robot_info``
(Data_Visualization_Code/Figure2.py:12-39): space-separated columns
z quat0-3 vel0-2 omega0-2 q0-11 dq0-11 t0-11 c0-3, torques normalized (x18
to Nm; knee additionally x1.55). :func:`dump_robot_info` writes a rollout of
this port in that format, :class:`RobotInfo` reads one back.
"""

from __future__ import annotations

import numpy as np

from high_speed_quadrupedal_locomotion_by_irrl_torch.phys.model import KNEE_RATIO

_TAU_SCALE = 18.0


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


class RobotInfo:
    """Reference "info" CSV log (Figure2.py:12-39 semantics)."""

    def __init__(self, path: str, is_wildcat: bool = False):
        with open(path) as f:
            header = f.readline().split()
        data = np.loadtxt(path, skiprows=1, ndmin=2)
        col = {name: i for i, name in enumerate(header)}

        def block(prefix, n):
            return np.stack([data[:, col[f"{prefix}{i}"]] for i in range(n)], axis=-1)

        self.z = data[:, col["z"]]
        self.quat = block("quat", 4)
        self.vel = block("vel", 3)
        self.omega = block("omega", 3)
        self.q = block("q", 12)
        self.dq = block("dq", 12)
        self.tau = block("t", 12) * _TAU_SCALE
        self.tau[:, 2::3] *= KNEE_RATIO          # knee gearing (Figure2.py:33-35)
        self.contact = block("c", 4)
        if is_wildcat:
            self.vel = self.vel * np.array([-1.0, 1.0, 1.0])

    @property
    def vel_body(self) -> np.ndarray:
        R = _quat_to_matrix_np(self.quat)
        return np.einsum("tji,tj->ti", R, self.vel)


def dump_robot_info(path: str, gc: np.ndarray, gv: np.ndarray,
                    tau: np.ndarray, contact: np.ndarray) -> str:
    """Write a rollout (gc (T,19), gv (T,18), tau (T,12) [Nm], contact (T,4))
    as a reference-format info CSV consumable by Figure2.py."""
    gc, gv = np.asarray(gc), np.asarray(gv)
    tau = np.asarray(tau) / _TAU_SCALE
    tau[:, 2::3] /= KNEE_RATIO
    header = (["z"] + [f"quat{i}" for i in range(4)]
              + [f"vel{i}" for i in range(3)] + [f"omega{i}" for i in range(3)]
              + [f"q{i}" for i in range(12)] + [f"dq{i}" for i in range(12)]
              + [f"t{i}" for i in range(12)] + [f"c{i}" for i in range(4)])
    rows = np.concatenate([
        gc[:, 2:3], gc[:, 3:7], gv[:, 0:3], gv[:, 3:6],
        gc[:, 7:19], gv[:, 6:18], tau, np.asarray(contact)], axis=-1)
    np.savetxt(path, rows, header=" ".join(header), comments="")
    return path
