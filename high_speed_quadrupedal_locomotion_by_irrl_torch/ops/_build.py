"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``. Libraries go to ``build/torch_kernels/`` at the repo
root, named by a hash of their source and flags, and are built at first use;
all missing libraries are built by concurrent ``nvcc`` processes, under a file
lock, so processes that start at once (the ranks of a distributed run) build
them once and the others wait and load them. Nothing is
built or imported at module import: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("phys_substep", "lstm_cell")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # name -> nvcc/ptxas output of this process's builds


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Build the missing libraries of ``names``, one ``nvcc`` each, all
    started together. Returns wall seconds per library built; raises with
    the compiler's output if one fails. The check and the build hold the
    build directory's lock."""
    if all(_lib_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked([n for n in names if not _lib_path(n).exists()])


def _build_locked(todo: list) -> dict[str, float]:
    if not todo:
        return {}
    nvcc = _nvcc()
    procs, t0 = {}, time.perf_counter()
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build(SOURCES)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
