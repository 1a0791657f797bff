"""PyTorch port: the native host runtime (``utils/native``).

The port compiles the repo's ``runtime/irrl_runtime.cpp`` itself, at first
use and under a file lock. Here it builds into a temporary directory: two
processes that start at once make one library; importing the module builds
nothing; a failed build raises with the compiler's message. Then the state
server / client round trip, the telemetry ring, and the table loader and
resampler against the JAX package's wrapper of the same runtime.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import native
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import native as jnative

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def built(tmp_path, monkeypatch):
    """The runtime built into ``tmp_path`` by two processes at once."""
    code = ("import sys; from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import "
            "native; print(native.build(sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    libs = sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".so")
    assert libs == [native.lib_path(tmp_path).name]          # one library, no leftovers
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    return tmp_path


def test_import_builds_nothing_and_a_failed_build_raises(tmp_path):
    code = ("import sys; from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import "
            "native; assert not native._libs\n"
            "try:\n    native.build(sys.argv[1])\nexcept RuntimeError as e:\n"
            "    print('raised', 'exit' in str(e))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CXX="false")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "raised True", out.stderr
    assert not native.lib_path(tmp_path).exists()


def test_state_server_roundtrip(built, rng):
    srv = native.StateServer(port=0)
    try:
        cli = native.StateClient(srv.port)
        assert cli.meta() == 0          # nothing published yet
        snap = rng.normal(size=44).astype(np.float32)
        srv.update(snap)
        seq, got = cli.state()
        assert seq == 1 and cli.meta() == 44
        np.testing.assert_array_equal(got, snap)
        srv.update(snap * 2)
        seq, got = cli.state()
        assert seq == 2 and srv.clients == 1
        np.testing.assert_array_equal(got, snap * 2)
        cli.close()
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.port


def test_telemetry_ring(built, rng):
    ring = native.TelemetryRing(4, 3)
    recs = rng.normal(size=(6, 3)).astype(np.float32)
    assert [ring.push(r) for r in recs] == [True] * 4 + [False] * 2   # full at capacity
    np.testing.assert_array_equal(ring.pop(), recs[:4])
    assert ring.dropped == 2
    assert ring.pop().shape == (0, 3)
    with pytest.raises(ValueError):
        ring.push(np.zeros(4))
    ring.close()


def test_table_and_resample_match_jax(built, tmp_path, rng):
    table = rng.normal(size=(50, 7)).astype(np.float32)
    path = tmp_path / "t.csv"
    np.savetxt(path, table, delimiter=",")
    np.testing.assert_array_equal(native.load_table(str(path)),
                                  jnative.load_table(str(path)))
    np.testing.assert_array_equal(native.resample(table, 0.01, 120, 0.002),
                                  jnative.resample(table, 0.01, 120, 0.002))
