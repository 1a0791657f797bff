"""PyTorch port: the native host runtime (``utils/native``).

The port compiles the repo's ``runtime/irrl_runtime.cpp`` itself, at first
use and under a file lock. Here it builds into a temporary directory: two
processes that start at once make one library; importing the module builds
nothing; a failed build raises with the compiler's message. Then the state
server / client round trip, the telemetry ring, and the table loader and
resampler against the JAX package's wrapper of the same runtime. The C
deployment policy (``NativePolicy``) is held to the port's
``models/lstm.deterministic_action`` on the same CSV export, as JAX's
``tests/test_native.py`` holds its own: random weights, and the in-repo
flagship export.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import native
from high_speed_quadrupedal_locomotion_by_irrl_tpu.utils import native as jnative

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP = ROOT / "artifacts" / "irrl_tpu_relaxed_4e8"


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


def _hold_to_deterministic_action(pol: native.NativePolicy, params, obs: np.ndarray) -> None:
    """Step by step over ``obs`` (T, 35): the C actor against the port's,
    within 2e-5 (the same float32 weights; only the order of the sums differs)."""
    state = torch.zeros((1, lstm.state_size([48, 48])))
    done = torch.zeros(1)
    for t in range(obs.shape[0]):
        want, state = lstm.deterministic_action(params, torch.from_numpy(obs[t:t + 1]), state,
                                                done)
        np.testing.assert_allclose(pol.act(obs[t]), want[0].numpy(), atol=2e-5, err_msg=f"step {t}")
    # the recurrent state [c0 | h0 | c1 | h1]: the actor's half of the port's (pi, then v)
    np.testing.assert_allclose(pol.state(), state[0, :pol.state().size].numpy(), atol=2e-5)


def test_native_policy_matches_deterministic_action(built, tmp_path, rng):
    """Random weights exported to CSV (JAX tests/test_native.py:107-139)."""
    params = lstm.init(torch.Generator().manual_seed(3), obs_dim=35, act_dim=12,
                       n_lstm=(48, 48), device="cpu")
    params.pi_w = params.pi_w * 100.0
    params.pi_b = torch.linspace(-1.5, 1.5, 12)   # actions on both sides of the [-1, 1] clip
    mio.save_bp5_csv(params, str(tmp_path), include_value=False)
    params = mio.load_bp5_csv(str(tmp_path), device="cpu")   # the weights C reads
    pol = native.NativePolicy(str(tmp_path))
    assert (pol.obs_dim, pol.act_dim) == (35, 12)
    assert pol.state().shape == (2 * (48 + 48),) and not pol.state().any()
    obs = rng.normal(scale=0.5, size=(60, 35)).astype(np.float32)
    _hold_to_deterministic_action(pol, params, obs)
    assert pol.state().any()
    assert np.abs(pol.act(obs[0])).max() == 1.0
    pol.reset()
    assert not pol.state().any()
    with pytest.raises(ValueError, match="obs shape"):
        pol.act(obs[0, :34])
    pol.close()
    with pytest.raises(RuntimeError, match="closed"):
        pol.act(obs[0])
    with pytest.raises(IOError, match="bp5 CSV"):
        native.NativePolicy(str(tmp_path / "missing"))


def test_native_policy_runs_the_flagship_export(built, rng):
    """The in-repo flagship export (the JAX test's bp5_155 is not in the repo)."""
    pol = native.NativePolicy(str(FLAGSHIP))
    params = mio.load_bp5_csv(str(FLAGSHIP), device="cpu")
    obs = rng.normal(scale=0.3, size=(60, 35)).astype(np.float32)
    obs[:, 0] = 1.0
    _hold_to_deterministic_action(pol, params, obs)
    pol.reset()
    assert not pol.state().any()
    again = np.stack([pol.act(o) for o in obs[:5]])
    pol.reset()
    np.testing.assert_array_equal(np.stack([pol.act(o) for o in obs[:5]]), again)
    pol.close()
