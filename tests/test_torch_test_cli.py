"""PyTorch port: ``cli/test.py`` end to end on the CPU.

Every flag of the JAX package's ``cli/test.py`` parses in the port's, and
every mode runs: one invocation with all the data and figure modes into
``tmp_path``, ``--viewer``, ``--vid``, ``--dump-info``, ``--save-energy-data``
and ``--save-data``, whose ``results.json`` must have the keys that the JAX
CLI writes for the same flags (``tests/test_torch_test_cli_refs.json``,
written by this file run as a script: the JAX CLI takes minutes to compile
every mode on the CPU); then ``--teleop --serve 0`` with the scripted pad,
a ``StateClient`` reading the 44-float snapshot while the loop runs, on
``--cfg configs/bp5_test.yaml`` and paced by ``--realtime``.

This file checks the CLI's plumbing; the physics and the analysis arithmetic
are held to JAX in ``test_torch_analysis.py``, ``test_torch_robustness.py``
and ``test_torch_landscape.py``. To keep it to seconds the rollouts step the
per-env ``envs.blackpanther.step`` (~0.04 s a control step on the CPU, the
plain ``step_batch`` loop ~1 s), the analysis rollout at --vx is run once
for all the modes that read it, and the experiments whose length the CLI
does not pass on (--kappa's 1500 steps, --landscape's 750) are shortened.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_test_cli.py refs
        rewrites the JAX side (~5 min)
"""

import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as tev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape as tls
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import robustness as trb
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as tcli
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import gamepad as tgp
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import native as tnative
from high_speed_quadrupedal_locomotion_by_irrl_tpu.cli import test as jcli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "test_torch_test_cli_refs.json"
ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
LANDSCAPE = "artifacts/irrl_tpu_imitation,artifacts/irrl_tpu_relaxed"
STEPS = 110     # past the analysis functions' 100-step skip


def _argv(tmp: Path) -> list:
    return ["--model", ARTIFACT, "--vx", "2.0", "--commands", "1,2", "--steps", str(STEPS),
            "--eval", "--wc", "--torque", "--ss", "--corr",
            "--pca", str(tmp / "pca.png"), "--spectro", str(tmp / "spec.png"),
            "--traces", str(tmp / "tr"), "--delay", "0,2", "--poincare", str(tmp / "poin.png"),
            "--save-data", str(tmp / "data"), "--save-energy-data", str(tmp / "energy"),
            "--kappa", "--kick", "1.0", "--kappa-entropy", "--ensemble", "8",
            "--landscape", LANDSCAPE, "--landscape-step", "0.5",
            "--viewer", str(tmp / "v.html"), "--vid", str(tmp / "v.gif"),
            "--dump-info", str(tmp / "info.csv"), "--material", "0.8,0.2,0.01"]


def _key_tree(x):
    """The keys of a results dict, rows of dicts by their first row."""
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [_key_tree(x[0])]
    return None


@pytest.fixture
def fast_cli(monkeypatch):
    monkeypatch.setattr(tbp, "step_batch", tbp.step)
    cache, real = {}, tev.policy_rollout

    def rollout(cfg, params, command, gen, n_steps=750, delay_steps=0, device=None, **kw):
        key = (np.asarray(command).tobytes(), n_steps, delay_steps)
        if key not in cache:
            cache[key] = real(cfg, params, command, gen, n_steps, delay_steps, device, **kw)
        return cache[key]
    monkeypatch.setattr(tev, "policy_rollout", rollout)
    monkeypatch.setattr(trb, "recovery_sweep",
                        functools.partial(trb.recovery_sweep, n_steps=40, kick_step=20))
    monkeypatch.setattr(trb, "fit_kappa", functools.partial(trb.fit_kappa, settle=5, window=20))
    monkeypatch.setattr(tls, "reward_landscape",
                        functools.partial(tls.reward_landscape, n_steps=10))


def test_test_yaml_copy_parses_as_jax_does():
    """configs/bp5_test.yaml, the port's copy of the JAX test preset, parses
    to the same fields."""
    import dataclasses

    from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
    from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig

    rel = "configs/bp5_test.yaml"
    tcfg = tconfig.from_yaml(str(ROOT / "high_speed_quadrupedal_locomotion_by_irrl_torch" / rel))
    jcfg = jconfig.from_yaml(str(ROOT / "high_speed_quadrupedal_locomotion_by_irrl_tpu" / rel))
    got, want = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert got == {k: want[k] for k in got} and set(got) <= set(want)
    assert tcfg.manual and not tcfg.stochastic_dynamics and tcfg.num_envs == 1


def test_every_jax_flag_parses():
    want = vars(jcli.parse_args(["--model", ARTIFACT]))
    got = vars(tcli.parse_args(["--model", ARTIFACT]))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want        # the same defaults
    assert got["device"] == "cuda"


def test_every_mode_runs_on_cpu(tmp_path, fast_cli, capsys):
    res = tcli.main(_argv(tmp_path) + ["--device", "cpu"])
    saved = json.loads((tmp_path / "data" / "results.json").read_text())
    want = json.loads(REFS.read_text())["results_keys"]
    got = _key_tree(saved)
    # the port's tracking rows also count the env's falls (its tracking_eval adds them)
    assert got["tracking"] == [{**want["tracking"][0], "falls": None}]
    assert {k: v for k, v in got.items() if k != "tracking"} == \
        {k: v for k, v in want.items() if k != "tracking"}
    assert saved["energy_data"] == ["contact", "gc", "gv", "inverse_mass", "nonlinear",
                                    "power", "torque"]
    assert res["landscape_points"] == 6 and len(res["recovery"]) == 2
    assert [r["command"] for r in res["entropy_kappa"]] == [1.0, 2.0]
    for name in ("pca.png", "spec.png", "tr_joints.png", "tr_ee.png", "poin.png", "v.gif",
                 "info.csv", "data/total_reward.txt", "data/reward_landscape.png",
                 "data/state_space_q.npy", "energy/inverse_mass.npy"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert np.load(tmp_path / "energy" / "inverse_mass.npy").shape == (STEPS, 18, 18)
    html = (tmp_path / "v.html").read_text()
    assert html.startswith("<!DOCTYPE html>") and "__DATA__" not in html
    assert len(np.loadtxt(tmp_path / "data" / "total_reward.txt", skiprows=1)) == 6
    for r in res["tracking"]:
        assert np.isfinite([r["v_mean"], r["err_mean"]]).all()
    out = capsys.readouterr().out
    for line in ("cmd 1.0 m/s -> v", "motor envelope violation rate", "TCoT",
                 "state-space q range", "LSTM state |corr| mean", "value-PCA map",
                 "latency 4.0 ms -> v", "kick 1.0 m/s -> kappa", "entropy-kappa",
                 "landscape: 6 blends", "viewer written", "info CSV written", "energy dump"):
        assert line in out, line


def test_teleop_serves_snapshots(monkeypatch, fast_cli, capsys):
    servers, reads = [], []

    class Server(tnative.StateServer):
        def __init__(self, port=0):
            super().__init__(port)
            servers.append(self.port)

    class ProbingPad(tgp.ScriptedPad):
        """The scripted schedule; at step 5 a viewer reads the server."""
        def poll(self):
            if len(reads) == 0 and self._t >= 5 * self.dt - 1e-9:
                cli = tnative.StateClient(servers[0])
                reads.append((cli.meta(), *cli.state()))
                cli.close()
            return super().poll()

    monkeypatch.setattr(tnative, "StateServer", Server)
    monkeypatch.setattr(tgp, "open_pad", lambda index=0, schedule=None, dt=0.002:
                        ProbingPad(schedule, dt))
    cfg = ROOT / "high_speed_quadrupedal_locomotion_by_irrl_torch" / "configs" / "bp5_test.yaml"
    t0 = time.perf_counter()
    res = tcli.main(["--model", ARTIFACT, "--cfg", str(cfg), "--teleop", "--serve", "0",
                     "--realtime", "--steps", "12", "--device", "cpu"])
    assert time.perf_counter() - t0 >= 12 * 0.002          # paced at control_dt
    assert _key_tree(res) == {"teleop": json.loads(REFS.read_text())["teleop_keys"]}
    assert res["teleop"]["steps"] == 12 and len(res["teleop"]["v_mean"]) == 3
    (meta, seq, snap), = reads
    assert meta == 44 and seq == 5 and snap.shape == (44,)
    np.testing.assert_array_equal(snap[41:], [0.0, 0.0, 0.0])    # the schedule's first second
    assert 0.2 < snap[2] < 0.4 and np.isfinite(snap).all()       # base height, standing
    out = capsys.readouterr().out
    assert f"state server on 127.0.0.1:{servers[0]}" in out
    assert "teleop: 12 steps" in out


def jax_results_keys(tmp: Path) -> dict:
    """The JAX CLI's results for the flags of :func:`_argv`, on the CPU, with
    the same experiments shortened: their keys."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import landscape as jls
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import robustness as jrb

    jrb.recovery_sweep = functools.partial(jrb.recovery_sweep, n_steps=40, kick_step=20)
    jrb.fit_kappa = functools.partial(jrb.fit_kappa, settle=5, window=20)
    jls.reward_landscape = functools.partial(jls.reward_landscape, n_steps=10)
    res = jcli.main(_argv(tmp) + ["--teleop", "--serve", "0"])
    return _key_tree(json.loads(json.dumps(res)))


if __name__ == "__main__":
    import tempfile

    if sys.argv[1:] != ["refs"]:
        raise SystemExit("usage: tests/test_torch_test_cli.py refs")
    with tempfile.TemporaryDirectory() as d:
        keys = jax_results_keys(Path(d))
    teleop = keys.pop("teleop")
    REFS.write_text(json.dumps({"results_keys": keys, "teleop_keys": teleop}, indent=1) + "\n")
    print(REFS.read_text())
