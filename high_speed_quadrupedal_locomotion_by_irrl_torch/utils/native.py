"""ctypes bindings for the native host runtime (``runtime/irrl_runtime.cpp``).

Port of ``utils/native.py`` without its numpy stand-ins: the library is
compiled from the repo's ``runtime/irrl_runtime.cpp`` with ``g++`` at first
use (never at import), into ``build/native/`` at the repo root, named by a
hash of source and flags. The build runs under a file lock, so processes
that start at once (test workers) build it once and the others wait for it.
A failed build raises with the compiler's output. API:

    load_table(path)           -> (rows, cols) float32 ndarray
    resample(table, dt_in, n_out, dt_out) -> float32 ndarray
    TelemetryRing(capacity, record_size)  -> lock-free push/pop ring
    StateServer(port) / StateClient(port) -> state streaming over TCP
    NativePolicy(model_dir)    -> the robot-side LSTM controller of a bp5
                                  CSV export, in C
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import socket
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "runtime" / "irrl_runtime.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-mtune=native", "-pthread",
             "-shared"]

_libs: dict[Path, ctypes.CDLL] = {}

_SIGNATURES = {
    "irrl_table_load": (ctypes.c_long, [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_long),
                                        ctypes.POINTER(ctypes.c_long)]),
    "irrl_resample": (None, [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_double,
                             ctypes.c_void_p, ctypes.c_long, ctypes.c_double]),
    "irrl_ring_create": (ctypes.c_void_p, [ctypes.c_long, ctypes.c_long]),
    "irrl_ring_destroy": (None, [ctypes.c_void_p]),
    "irrl_ring_push": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
    "irrl_ring_pop": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]),
    "irrl_ring_dropped": (ctypes.c_long, [ctypes.c_void_p]),
    "irrl_server_create": (ctypes.c_void_p, [ctypes.c_int]),
    "irrl_server_port": (ctypes.c_int, [ctypes.c_void_p]),
    "irrl_server_clients": (ctypes.c_long, [ctypes.c_void_p]),
    "irrl_server_update": (None, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]),
    "irrl_server_destroy": (None, [ctypes.c_void_p]),
    "irrl_policy_create": (ctypes.c_void_p, [ctypes.c_char_p]),
    "irrl_policy_obs_dim": (ctypes.c_int, [ctypes.c_void_p]),
    "irrl_policy_act_dim": (ctypes.c_int, [ctypes.c_void_p]),
    "irrl_policy_reset": (None, [ctypes.c_void_p]),
    "irrl_policy_state": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_void_p]),
    "irrl_policy_act": (None, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
    "irrl_policy_destroy": (None, [ctypes.c_void_p]),
}


def lib_path(build_dir: Path | None = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir or BUILD_DIR) / f"libirrl_runtime-{digest}.so"


def build(build_dir: Path | None = None) -> Path:
    """Compile the runtime into ``build_dir`` (default ``build/native``)
    unless it is there; the check and the build hold the directory's lock.
    Returns the library's path; raises with g++'s output if it fails."""
    out = lib_path(build_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cxx = os.environ.get("CXX", "g++")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building the native runtime failed ({cxx} exit "
                                   f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    path = lib_path()
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[path] = lib
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def load_table(path: str) -> np.ndarray:
    """Fast numeric-table load (CSV / whitespace / semicolon separated)."""
    lib = _load()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    n = lib.irrl_table_load(os.fsencode(path), None, 0, ctypes.byref(rows), ctypes.byref(cols))
    if n < 0:
        raise IOError(f"irrl_table_load failed ({n}) for {path}")
    out = np.empty(n, dtype=np.float32)
    lib.irrl_table_load(os.fsencode(path), _ptr(out), n, ctypes.byref(rows), ctypes.byref(cols))
    return out.reshape(rows.value, cols.value)


def resample(table: np.ndarray, dt_in: float, n_out: int, dt_out: float) -> np.ndarray:
    """Linear time-resampling of an (n, cols) trajectory table."""
    table = np.ascontiguousarray(table, dtype=np.float32)
    out = np.empty((n_out, table.shape[1]), dtype=np.float32)
    _load().irrl_resample(_ptr(table), table.shape[0], table.shape[1], dt_in, _ptr(out), n_out,
                          dt_out)
    return out


class TelemetryRing:
    """Lock-free SPSC ring of fixed-size float records."""

    def __init__(self, capacity: int, record_size: int):
        self.record_size = record_size
        self._lib = _load()
        self._h = self._lib.irrl_ring_create(capacity, record_size)

    def push(self, rec: np.ndarray) -> bool:
        rec = np.ascontiguousarray(rec, dtype=np.float32)
        if rec.size != self.record_size:
            raise ValueError(f"record of {rec.size} floats, the ring holds {self.record_size}")
        return bool(self._lib.irrl_ring_push(self._h, _ptr(rec)))

    def pop(self, max_records: int = 1 << 16) -> np.ndarray:
        out = np.empty((max_records, self.record_size), dtype=np.float32)
        n = self._lib.irrl_ring_pop(self._h, _ptr(out), max_records)
        return out[:n]

    @property
    def dropped(self) -> int:
        return int(self._lib.irrl_ring_dropped(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.irrl_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class StateServer:
    """Native TCP state-streaming server — the RaisimServer twin
    (RaisimServer.hpp:53-470). Publish with update(state); remote viewers
    poll with StateClient."""

    def __init__(self, port: int = 0):
        self._lib = _load()
        self._h = self._lib.irrl_server_create(port)
        if not self._h:
            raise OSError(f"could not bind state server on port {port}")

    def _handle(self):
        if not self._h:
            raise RuntimeError("the state server is closed")
        return self._h

    @property
    def port(self) -> int:
        return int(self._lib.irrl_server_port(self._handle()))

    @property
    def clients(self) -> int:
        return int(self._lib.irrl_server_clients(self._handle()))

    def update(self, state: np.ndarray) -> None:
        state = np.ascontiguousarray(state, dtype=np.float32).ravel()
        self._lib.irrl_server_update(self._handle(), _ptr(state), state.size)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.irrl_server_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class StateClient:
    """Deserializer twin (visualizer/deserializer.hpp:40-341): connects to a
    StateServer and polls state snapshots."""

    def __init__(self, port: int, host: str = "127.0.0.1", timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("state server closed the connection")
            buf += chunk
        return buf

    def meta(self) -> int:
        """Snapshot length in floats (REQUEST_META)."""
        self._sock.sendall(b"\x02")
        return int(np.frombuffer(self._recv_exact(4), dtype=np.uint32)[0])

    def state(self) -> tuple[int, np.ndarray]:
        """(sequence number, latest snapshot) via REQUEST_STATE."""
        self._sock.sendall(b"\x01")
        seq = int(np.frombuffer(self._recv_exact(4), dtype=np.uint32)[0])
        n = int(np.frombuffer(self._recv_exact(4), dtype=np.uint32)[0])
        data = np.frombuffer(self._recv_exact(4 * n), dtype=np.float32).copy()
        return seq, data

    def close(self) -> None:
        if getattr(self, "_sock", None):
            self._sock.close()
            self._sock = None


class NativePolicy:
    """Robot-side deployment runtime: the native C twin of the reference's
    NumPy onboard controller (CustomerLstmNN.predict, CustomerLstmNN.py:96-134).
    Loads a bp5 CSV export and runs the stacked-LSTM actor at 500 Hz with no
    Python or PyTorch in the control loop (the C side keeps the recurrent
    state); it agrees with :func:`..models.lstm.deterministic_action` on the
    same export."""

    def __init__(self, model_dir: str):
        self._lib = _load()
        self._h = self._lib.irrl_policy_create(os.fsencode(model_dir))
        if not self._h:
            raise IOError(f"failed to load a bp5 CSV policy from {model_dir}")
        self.obs_dim = self._lib.irrl_policy_obs_dim(self._h)
        self.act_dim = self._lib.irrl_policy_act_dim(self._h)

    def _handle(self):
        if not self._h:
            raise RuntimeError("the policy is closed")
        return self._h

    def reset(self) -> None:
        """Zero the recurrent state (episode boundary, robot power-on)."""
        self._lib.irrl_policy_reset(self._handle())

    def act(self, obs: np.ndarray) -> np.ndarray:
        """One control step: normalized obs -> action clipped to [-1, 1].
        Advances the internal LSTM state."""
        obs = np.ascontiguousarray(obs, dtype=np.float32)
        if obs.shape != (self.obs_dim,):
            raise ValueError(f"obs shape {obs.shape} != ({self.obs_dim},)")
        out = np.empty(self.act_dim, dtype=np.float32)
        self._lib.irrl_policy_act(self._handle(), _ptr(obs), _ptr(out))
        return out

    def state(self) -> np.ndarray:
        """Recurrent state snapshot, per-layer [c|h] packing (the layout of
        models/lstm.state_size)."""
        h = self._handle()
        out = np.empty(self._lib.irrl_policy_state(h, None), dtype=np.float32)
        return out[:self._lib.irrl_policy_state(h, _ptr(out))]

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.irrl_policy_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
