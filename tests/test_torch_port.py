"""PyTorch port: package rules that hold whatever the module.

- no module of the port, and not chip_smoke.py, imports JAX or the JAX package;
- entry points run on CUDA unless the caller asks for the CPU, and raise
  without a GPU instead of falling back;
- the kernel wrappers and the build module import and refuse bad input
  without nvcc or a GPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as tdevice
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as tcli
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import (
    _build, lstm_cuda, pd_torque, phys_cuda,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as tlanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import high_speed_quadrupedal_locomotion_by_irrl_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'high_speed_quadrupedal_locomotion_by_irrl_tpu'))
print(len(names), bad)
assert len(names) >= 15, names
slice4 = {'mpc.srb', 'mpc.runtime', 'ops.linalg', 'analysis.rawdata', 'analysis.parity', 'cli.mpc'}
assert {pkg.__name__ + '.' + m for m in slice4} <= set(names), names
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_resolve_device_policy(monkeypatch):
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdevice.resolve(dev)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.test_default()
    with pytest.raises(RuntimeError):
        tmdl.nominal_params(cfg)
    with pytest.raises(RuntimeError):
        tio.load_bp5_csv(ARTIFACT)
    with pytest.raises(RuntimeError):
        tbp.env_init(cfg, 1, torch.Generator())
    with pytest.raises(RuntimeError):
        tcli.main(["--model", ARTIFACT, "--eval", "--steps", "1"])
    # asking for the CPU works
    assert tmdl.nominal_params(cfg, "cpu").mass.device.type == "cpu"
    assert tio.load_bp5_csv(ARTIFACT, device="cpu").pi_w.shape == (48, 12)


def test_kernel_wrappers_reject_non_cpu_non_cuda_tensors():
    """A tensor that is on neither the CPU nor the card is refused, never run
    through the plain version."""
    B = 4
    P = tlanes.params_to_lanes(tmdl.nominal_params(None, "cpu").expand(B))
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        phys_cuda.substep(P, meta(19, B), meta(18, B), meta(12, B), meta(6, B), 0.1, 0.0, 2.5e-4)
    w = tlstm.LSTMWeights(wx=meta(35, 192), wh=meta(48, 192), b=meta(192))
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_cell(w, meta(B, 35), meta(B, 48), meta(B, 48))


def test_build_needs_nvcc_and_names_libraries_by_content(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["lstm_cell"])
    names = {_build._lib_path(n).name for n in _build.SOURCES}
    assert len(names) == 2 and all(n.endswith(".so") for n in names)
    assert _build.BUILD_DIR == tmp_path / "build"


def test_launch_counters_stay_put_on_cpu():
    """Counters count kernel launches only; the CPU path is the plain version."""
    before = (phys_cuda.launches, lstm_cuda.launches)
    B = 2
    P = tlanes.params_to_lanes(tmdl.nominal_params(None, "cpu").expand(B))
    gc = torch.from_numpy(np.tile(tmdl.stand_gc(), (B, 1)).T.astype(np.float32).copy())
    phys_cuda.substep(P, gc, torch.zeros(18, B), torch.zeros(12, B), torch.zeros(6, B),
                      0.1, 0.0, 2.5e-4)
    w = tlstm.LSTMWeights(wx=torch.zeros(35, 192), wh=torch.zeros(48, 192), b=torch.zeros(192))
    lstm_cuda.lstm_cell(w, torch.zeros(B, 35), torch.zeros(B, 48), torch.zeros(B, 48))
    assert (phys_cuda.launches, lstm_cuda.launches) == before


def test_fused_entry_counters_stay_put_on_cpu():
    """The same for the entries the main path calls: the fused control step
    and the two-tower LSTM launch."""
    before = (phys_cuda.launches, lstm_cuda.launches)
    B = 2
    P = tlanes.params_to_lanes(tmdl.nominal_params(None, "cpu").expand(B))
    gc = torch.from_numpy(np.tile(tmdl.stand_gc(), (B, 1)).T.astype(np.float32).copy())
    pd = pd_torque.from_config(tconfig.test_default())
    out = phys_cuda.control_step(P, pd, gc, torch.zeros(18, B), gc[7:].clone(),
                                 torch.zeros(12, B), torch.zeros(6, B), 2, 0.1, 0.0, 2.5e-4)
    assert len(out) == 7 and out[6].shape == (12, B)
    p = tlstm.init(torch.Generator().manual_seed(0), device="cpu")
    tlstm.forward(p, torch.zeros(B, 35), torch.zeros(B, 384), torch.zeros(B))
    assert (phys_cuda.launches, lstm_cuda.launches) == before


def test_smoke_bound_counts_fewer_operations_than_the_plain_version():
    """The operations bound of the physics kernel counts what the function
    needs (composite form, leg-first solve), so it stays under what the plain
    version does and scales with the substeps."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    B = 2
    P = tlanes.params_to_lanes(tmdl.nominal_params(None, "cpu").expand(B))
    gc = torch.from_numpy(np.tile(tmdl.stand_gc(), (B, 1)).T.astype(np.float32).copy())
    plain = chip_smoke.count_ops(lambda: tlanes.substep(
        P, gc, torch.zeros(18, B), torch.zeros(12, B), torch.zeros(6, B), 0.1, 0.0, 2.5e-4)) / B
    need = chip_smoke.phys_ops_per_env(1, pd_law=False)
    assert 0.25 * plain < need < 0.5 * plain
    one, eight = (chip_smoke.phys_ops_per_env(n, pd_law=True, motor_dynamics=True)
                  for n in (1, 8))
    assert eight == 8 * one and one > need
