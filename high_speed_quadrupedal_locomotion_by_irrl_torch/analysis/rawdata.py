"""The reference's recorded-data formats, in numpy only.

Port of ``analysis/rawdata.py``:

* the "info" CSV log (Data_Visualization_Code/Figure2.py:12-39):
  space-separated columns z quat0-3 vel0-2 omega0-2 q0-11 dq0-11 t0-11 c0-3,
  torques normalized (x18 to Nm; knee additionally x1.55).
  :func:`dump_robot_info` writes a rollout of this port in that format,
  :class:`RobotInfo` reads one back;
* the "body-center" float32 stream with its Param YAML sidecar
  (Figure3.py:17-60), read by :class:`RobotBodyInfo`.
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


class RobotBodyInfo:
    """Reference "body-center" binary stream + Param YAML sidecar
    (Figure3.py:17-60). Record: [x y z quat(wxyz) vel(3) omega(3)].

    NOTE: the reference builds its rotation matrices from
    (quat0, quat1, quat1, quat3), an evident typo (Figure3.py:50-51); this
    reader uses the correct (w, x, y, z), as the JAX package's does."""

    def __init__(self, bin_file: str, param_file: str):
        import yaml

        with open(param_file) as f:
            self.cfg = yaml.safe_load(f)
        seg_len = int(self.cfg["seg_len"])
        self.n_episodes = int(self.cfg["NoE"])
        self.frames_per_episode = int(self.cfg["FoE"])
        self.n_env = int(self.cfg["Num_Of_Env"])
        self.skip = int(self.cfg["skip_frame"])
        self.noise = np.array([self.cfg.get(k, 0.0) for k in (
            "z_noise", "roll_noise", "pitch_noise",
            "z_dot_noise", "roll_dot_noise", "pitch_dot_noise")])

        raw = np.fromfile(bin_file, dtype=np.float32)
        total = self.n_episodes * (self.frames_per_episode // self.skip) * self.n_env
        heads = np.arange(0, total, seg_len)
        tails = np.minimum(heads + seg_len, total)
        data = np.empty((13, total), dtype=np.float64)
        for h, t in zip(heads, tails):
            data[:, h:t] = raw[h * 13:t * 13].reshape(13, -1)
        self.data = data.T                       # (total, 13)

    @property
    def pos(self) -> np.ndarray:
        return self.data[:, 0:3]

    @property
    def quat(self) -> np.ndarray:
        return self.data[:, 3:7]

    @property
    def vel_body(self) -> np.ndarray:
        R = _quat_to_matrix_np(self.data[:, 3:7])
        return np.einsum("tji,tj->ti", R, self.data[:, 7:10])

    @property
    def omega_body(self) -> np.ndarray:
        R = _quat_to_matrix_np(self.data[:, 3:7])
        return np.einsum("tji,tj->ti", R, self.data[:, 10:13])

    @property
    def z_axis(self) -> np.ndarray:
        """World z expressed in each frame's rotation (posture indicator)."""
        return _quat_to_matrix_np(self.data[:, 3:7])[:, 2, :]

    @property
    def posture(self) -> np.ndarray:
        """(T, 3) roll/pitch/yaw, ZYX: Rotation.py's qua2euler semantics."""
        w, x, y, z = (self.data[:, 3], self.data[:, 4], self.data[:, 5], self.data[:, 6])
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return np.stack([roll, pitch, yaw], axis=-1)

    def _formatted(self, arr: np.ndarray) -> np.ndarray:
        """The reference's ensemble view (Figure4.py:76-100):
        (NoEnv, FoE//skip, NoE, k)."""
        per = self.frames_per_episode // self.skip
        return arr.reshape(self.n_env, per, self.n_episodes, arr.shape[-1])

    @property
    def vel_formatted(self) -> np.ndarray:
        return self._formatted(self.vel_body)

    @property
    def omega_formatted(self) -> np.ndarray:
        return self._formatted(self.omega_body)

    @property
    def posture_formatted(self) -> np.ndarray:
        return self._formatted(self.posture)

    def episodes(self) -> np.ndarray:
        """(NoE*NoEnv, FoE//skip, 13) view grouped per recorded episode."""
        per = self.frames_per_episode // self.skip
        return self.data.reshape(-1, per, 13)
