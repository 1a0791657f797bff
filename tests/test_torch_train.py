"""PyTorch port: the training entry point (cli/train.py) and what it writes.

Tiny runs on the CPU (``--device cpu``, 4 envs, 8 steps: the per-env physics,
by the JAX package's rule): the run directory, the metrics stream,
checkpoints and CSV exports, resume, the physics path each width and flag
picks, the flags that are not ported yet, the device policy, and the port's
own YAML copies against the JAX package's.
"""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import train as ttrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import logger as tlogger
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import metrics as tmetrics
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling as tprof
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import run_dir as trun_dir
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.cli import train as jtrain
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio

torch.set_num_threads(1)

TORCH_PKG = os.path.dirname(tconfig.__file__)
JAX_PKG = os.path.dirname(jconfig.__file__)
ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
TINY = ["--device", "cpu", "--num-envs", "4", "--n-steps", "8"]
METRIC_KEYS = {"loss", "pg_loss", "vf_loss", "entropy", "approxkl", "clipfrac",
               "explained_variance", "ep_rew_mean", "ep_len_mean", "ep_count", "reward_per_step",
               "fps", "timesteps"}


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """`cli.train --device cpu --num-envs 4 --n-steps 8 --max-updates 2`,
    warm-started from the flagship CSV export."""
    log_dir = str(tmp_path_factory.mktemp("runs"))
    run = ttrain.main(TINY + ["--max-updates", "2", "--log-dir", log_dir, "--load", ARTIFACT,
                              "--lr", "5e-4", "--seed", "3"])
    return run


def test_train_cli_writes_its_run_directory(first_run):
    names = set(os.listdir(first_run))
    assert {"metrics.jsonl", "ckpt_final.pkl", "csv_final", "ckpt_1.pkl", "csv_1", "ckpt_2.pkl",
            "csv_2", "config.txt", "blackpanther.py"} <= names
    rows = tmetrics.read_jsonl(os.path.join(first_run, "metrics.jsonl"))
    assert len(rows) == 2 and [r["timesteps"] for r in rows] == [32, 64]
    for r in rows:
        assert METRIC_KEYS <= set(r) and all(np.isfinite(v) for v in r.values())
    # the snapshot is the port's env source, and the config is the one that ran
    with open(os.path.join(first_run, "blackpanther.py")) as f, \
            open(os.path.join(TORCH_PKG, "envs", "blackpanther.py")) as g:
        assert f.read() == g.read()
    with open(os.path.join(first_run, "config.txt")) as f:
        cfg_txt = f.read()
    assert "num_envs: 4\n" in cfg_txt and "seed: 3\n" in cfg_txt


def test_final_checkpoint_and_csv_hold_the_trained_parameters(first_run):
    params, adam, step = tio.load_checkpoint(os.path.join(first_run, "ckpt_final.pkl"), "cpu")
    assert step == 2 and adam["count"] == 20 and adam["lr"] == 5e-4   # 2 updates x 10 epochs
    start = tio.policy_params_to_numpy(tio.load_bp5_csv(ARTIFACT, device="cpu"))
    trained = tio.policy_params_to_numpy(params)
    assert all(np.abs(trained[k] - start[k]).max() > 0 for k in trained), "a leaf did not train"
    from_csv = tio.policy_params_to_numpy(
        tio.load_bp5_csv(os.path.join(first_run, "csv_final"), device="cpu"))
    for k in trained:   # the %.6f format: half a unit of the sixth decimal
        np.testing.assert_allclose(from_csv[k], trained[k], atol=5.1e-7, err_msg=k)
    # the JAX package reads the export too
    jp = jio.load_bp5_csv(os.path.join(first_run, "csv_final"))
    np.testing.assert_array_equal(np.asarray(jp.pi_lstm[1].wh), from_csv["pi_lstm.1.wh"])
    np.testing.assert_array_equal(np.asarray(jp.logstd), from_csv["logstd"])


def test_resume_continues_the_run(first_run, tmp_path):
    ckpt = os.path.join(first_run, "ckpt_final.pkl")
    run2 = ttrain.main(TINY + ["--max-updates", "1", "--log-dir", str(tmp_path), "--resume", ckpt])
    _, adam, step = tio.load_checkpoint(os.path.join(run2, "ckpt_final.pkl"), "cpu")
    # Adam went on counting from the checkpoint's 20 steps at the checkpoint's lr;
    # the update counter starts anew, as in the JAX package
    assert adam["count"] == 30 and adam["lr"] == 5e-4 and step == 1
    assert len(tmetrics.read_jsonl(os.path.join(run2, "metrics.jsonl"))) == 1
    # --load of a checkpoint takes the parameters only: Adam starts fresh
    run3 = ttrain.main(TINY + ["--max-updates", "1", "--log-dir", str(tmp_path), "--load", ckpt,
                               "--logstd", "-1.5", "--lr-final", "1e-4"])
    _, adam3, _ = tio.load_checkpoint(os.path.join(run3, "ckpt_final.pkl"), "cpu")
    assert adam3["count"] == 10 and adam3["lr"] == 1e-3
    row = tmetrics.read_jsonl(os.path.join(run3, "metrics.jsonl"))[0]
    assert row["lr"] == 1e-3
    np.testing.assert_allclose(row["entropy"], 12 * (-1.5 + 0.5 * (np.log(2 * np.pi) + 1)), atol=0.05)


@pytest.mark.parametrize("flag,match", [(["--distributed"], "multi-GPU")])
def test_flags_that_are_not_ported_raise(flag, match, tmp_path, capsys):
    """No flag of the JAX package's cli/train.py is refused any more:
    --distributed, the last one, trains data-parallel (here a world of one
    over a local store and gloo), says so, writes one run directory and
    leaves no process group behind."""
    run = ttrain.main(TINY + ["--max-updates", "1", "--log-dir", str(tmp_path)] + flag)
    assert f"{match}: 1 ranks over gloo, 4 envs a rank" in capsys.readouterr().out
    assert os.listdir(tmp_path) == [os.path.basename(run)] and not dist.is_initialized()
    assert len(tmetrics.read_jsonl(os.path.join(run, "metrics.jsonl"))) == 1
    assert os.path.exists(os.path.join(run, "ckpt_final.pkl"))


class _Picked(Exception):
    """Raised in place of training, carrying the physics path chosen."""


@pytest.mark.parametrize("flags", [[], ["--lanes"], ["--no-lanes"], ["--lanes", "--no-lanes"]])
@pytest.mark.parametrize("num_envs", [4, 1023, 1024])
def test_lanes_rule_picks_the_physics_as_jax_does(num_envs, flags, tmp_path, monkeypatch, capsys):
    """cli.train picks the batch-in-lanes or the per-env physics exactly as the
    JAX package's cli/train.py:93-118 does, and says which."""
    def picked(*args, **kw):
        env_cfg = next(a for a in args + tuple(kw.values()) if hasattr(a, "use_lanes_physics"))
        raise _Picked(env_cfg.use_lanes_physics)
    monkeypatch.setattr(jtrain, "_train", picked)
    monkeypatch.setattr(ttrain.ppo, "learn", picked)
    argv = ["--num-envs", str(num_envs), "--max-updates", "1"] + flags
    with pytest.raises(_Picked) as want:
        jtrain.main(argv + ["--log-dir", str(tmp_path / "jax")])
    capsys.readouterr()
    with pytest.raises(_Picked) as got:
        ttrain.main(argv + ["--device", "cpu", "--log-dir", str(tmp_path / "port")])
    lanes = got.value.args[0]
    assert lanes == want.value.args[0] == ((num_envs >= 1024 or "--lanes" in flags)
                                           and "--no-lanes" not in flags)
    assert ("physics path: batch-in-lanes" if lanes else "physics path: per-env") \
        in capsys.readouterr().out


def test_terrain_curriculum_without_a_terrain_config_exits(tmp_path):
    with pytest.raises(SystemExit, match="needs a terrain config"):
        ttrain.main(TINY + ["--max-updates", "1", "--log-dir", str(tmp_path),
                            "--terrain-z-curriculum", "0.0,0.1"])
    assert not os.listdir(tmp_path)
    # --distributed refuses the curriculum (the JAX package ignores it there)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ttrain.main(TINY + ["--cfg", os.path.join(TORCH_PKG, "configs", "bp5_relax_terrain.yaml"),
                            "--log-dir", str(tmp_path), "--distributed",
                            "--terrain-z-curriculum", "0.0,0.1"])


def test_cli_test_evaluates_a_port_checkpoint(first_run, capsys):
    """cli.test --model takes a checkpoint that cli.train wrote, and still
    refuses the JAX package's with load_checkpoint's message."""
    from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as ttest
    ckpt = os.path.join(first_run, "ckpt_final.pkl")
    res = ttest.main(["--model", ckpt, "--eval", "--commands", "1", "--steps", "3",
                      "--device", "cpu"])
    assert len(res["tracking"]) == 1 and np.isfinite(res["tracking"][0]["v_mean"])
    assert "cmd 1.0 m/s -> v " in capsys.readouterr().out
    # the run's CSV export (the same update, rounded to 6 decimals) rolls the same
    got = ttest.main(["--model", os.path.join(first_run, "csv_final"), "--eval",
                      "--commands", "1", "--steps", "3", "--device", "cpu"])
    assert abs(got["tracking"][0]["v_mean"] - res["tracking"][0]["v_mean"]) < 1e-4


def test_cli_test_refuses_a_jax_checkpoint(tmp_path):
    path = str(tmp_path / "jax_ckpt.pkl")
    jio.save_checkpoint(path, (jio.load_bp5_csv(ARTIFACT), None), 0)
    from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as ttest
    with pytest.raises(ValueError, match="not a checkpoint of the PyTorch port"):
        ttest.main(["--model", path, "--eval", "--steps", "1", "--device", "cpu"])


def test_no_silent_cpu_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ttrain.main(["--num-envs", "4", "--n-steps", "8", "--max-updates", "1",
                     "--log-dir", str(tmp_path)])
    assert ttrain.parse_args([]).device == "cuda" and ttrain.parse_args(["--lanes"]).lanes
    assert ttrain.parse_args(["--l", "5e-4"]).lr == 5e-4


def test_learn_hooks_schedule_and_interrupt():
    """state_hook before each update with the run fraction, metrics_hook and
    callback after it, the lr schedule written into the optimizer, and a
    KeyboardInterrupt returning the live state."""
    env_cfg = tconfig.train_default().replace(num_envs=2)
    cfg = tppo.PPOConfig(n_lstm=(8, 8), n_steps=4, noptepochs=1, learning_rate=1e-3, lr_final=1e-4)
    fracs, rows, called, lrs = [], [], [], []

    def state_hook(ts, frac):
        fracs.append(frac)
        return ts

    def metrics_hook(m):
        rows.append(m)
        if len(rows) == 3:
            raise KeyboardInterrupt

    def callback(ts, m):
        called.append(ts.update_idx)
        lrs.append(ts.opt_state.param_groups[0]["lr"])

    ts = tppo.learn(env_cfg, cfg, total_timesteps=5 * 8, seed=0, eval_every_n=2,
                    callback=callback, verbose=False, metrics_hook=metrics_hook,
                    state_hook=state_hook, device="cpu")
    assert fracs == [0.0, 0.25, 0.5] and ts.update_idx == 3   # interrupted in the third
    assert called == [1] and lrs == [1e-3]   # i = 0 only: the third update's callback never ran
    np.testing.assert_allclose([r["lr"] for r in rows], [1e-3, 7.75e-4, 5.5e-4], rtol=1e-12)
    assert ts.opt_state.param_groups[0]["lr"] == pytest.approx(5.5e-4)
    assert [r["timesteps"] for r in rows] == [8, 16, 24]


@pytest.mark.parametrize("name", ["bp5_train.yaml", "bp5_imitation.yaml",
                                  "bp5_imitation_terrain.yaml", "bp5_relax_terrain.yaml"])
def test_yaml_copies_parse_to_the_same_fields(name):
    tcfg = tconfig.from_yaml(os.path.join(TORCH_PKG, "configs", name))
    jcfg = jconfig.from_yaml(os.path.join(JAX_PKG, "configs", name))
    got, want = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert got == {k: want[k] for k in got} and set(got) <= set(want)
    assert tcfg.episode_len == 750 and tcfg.wildcat and tcfg.stochastic_dynamics
    assert tcfg.terrain == ("terrain" in name) and tcfg.terrain_sampled
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(TORCH_PKG, "configs", "*")))\
        == ["bp5_imitation.yaml", "bp5_imitation_terrain.yaml", "bp5_relax_terrain.yaml",
            "bp5_test.yaml", "bp5_train.yaml"]


def test_loggers_and_run_dir(tmp_path, capsys):
    with tmetrics.JsonlLogger(str(tmp_path / "a" / "m.jsonl")) as log:
        log.write({"loss": torch.tensor(0.5), "n": 3, "tag": "x"})
        log.write({"loss": np.float32(0.25)})
    assert tmetrics.read_jsonl(str(tmp_path / "a" / "m.jsonl")) == [
        {"loss": 0.5, "n": 3.0, "tag": "x"}, {"loss": 0.25}]
    ml = tlogger.MetricsLogger(str(tmp_path / "b"))
    ml.log(7, {"loss": 1.5})
    ml.close()
    row = tmetrics.read_jsonl(str(tmp_path / "b" / "metrics.jsonl"))[0]
    assert row["step"] == 7 and row["loss"] == 1.5 and "wall_s" in row
    assert "[7]" in capsys.readouterr().out
    cfg = tconfig.train_default()
    extra = tmp_path / "extra.yaml"
    extra.write_text("x: 1\n")
    d1 = trun_dir.make_run_dir(str(tmp_path / "runs"), cfg, [str(extra), "missing.yaml"])
    d2 = trun_dir.make_run_dir(str(tmp_path / "runs"), cfg)
    assert d1 != d2 and os.path.exists(os.path.join(d1, "extra.yaml"))
    assert {"config.txt", "blackpanther.py"} <= set(os.listdir(d2))


def test_profiling_helpers(tmp_path):
    """``trace`` writes the spans opened inside it as rows of ``trace.json``."""
    tprof.take()
    with tprof.trace(str(tmp_path / "trace")):
        with tprof.span("test.outer"):
            with tprof.span("test.inner"):
                torch.ones(4).sum()
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        rows = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"test.outer", "test.inner"} <= rows
    assert [s.name for s in tprof.take().spans] == ["test.outer", "test.inner"]
    assert not hasattr(tprof, "enable_compile_cache")
    assert not hasattr(tprof, "RateMeter") and not hasattr(tprof, "timed")


def test_port_modules_import_no_jax():
    """No module of the port imports JAX or the JAX package (its tests do)."""
    bad = []
    for path in glob.glob(os.path.join(TORCH_PKG, "**", "*.py"), recursive=True):
        with open(path) as f:
            for i, line in enumerate(f, 1):
                code = line.split("#")[0].strip()
                if code.startswith(("import jax", "from jax", "import optax", "from optax")) or (
                        code.startswith(("import ", "from ")) and "irrl_tpu" in code):
                    bad.append(f"{path}:{i}: {line.strip()}")
    assert not bad, bad
    assert jax is not None
