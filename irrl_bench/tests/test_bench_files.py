"""The benchmark's files: every configuration, cell, traffic and per-layer
metric that ``BENCHMARK.json`` names is a file of its own, found by name; the
names and units keep to their characters; a metric's reader declares the
layer, source and end-to-end metric ``BENCHMARK.json`` gives it; and nothing
the harness loads is JAX or the JAX package."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _run_module():
    spec = importlib.util.spec_from_file_location("irrl_bench_run", os.path.join(HERE, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_name_has_its_file():
    b = _bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"irrl_bench/configs/{c['name']}.json"
    for w in b["workloads"]:
        with open(os.path.join(HERE, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert int(cell["chips"]) == w["chips"]
        assert os.path.exists(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "entries", cell["entry"] + ".py"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))


def test_names_and_units_keep_to_their_characters():
    b = _bench()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[key]}) == len(b[key])


def test_metric_readers_declare_what_the_benchmark_says():
    b = _bench()
    run = _run_module()
    layers = {}
    for m in b["per_layer"]:
        mod = run.load_module("metrics", m["name"])
        assert (mod.LAYER, mod.SOURCE, mod.MOVES) == (m["layer"], m["source"], m["moves"])
        assert mod.read({"window": {"seconds": 1.0, "units": 1, "work": 1.0}, "layers": {},
                         "work": {}, "sites": {}, "profile": None, "ops": {}}) is None
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_each_cell_reports_setup_a_rate_and_a_layer():
    b = _bench()
    run = _run_module()
    for w in b["workloads"]:
        with open(os.path.join(HERE, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        e2e, layer = run.cell_metrics(b, w["name"], {"setup_s", cell["rate_metric"]})
        assert {m["name"] for m in e2e} == {"setup_s", cell["rate_metric"]}
        assert layer and all(m["moves"] == cell["rate_metric"] for m in layer)


def test_a_cell_added_as_files_is_picked_up():
    b = _bench()
    run = _run_module()
    b["workloads"].append({"name": "bp5_train_64", "config": "irrl_bp5_lstm",
                           "traffic": "ppo_64x750", "chips": 1, "why": "a later cell"})
    b["end_to_end"][0]["workloads"].append("bp5_train_64")
    for m in b["per_layer"]:
        if m["moves"] == "train_env_steps_per_s":
            m["workloads"].append("bp5_train_64")
    e2e, layer = run.cell_metrics(b, "bp5_train_64", {"setup_s", "train_env_steps_per_s"})
    assert {m["name"] for m in e2e} == {"train_env_steps_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {m["name"] for m in b["per_layer"]
                                          if m["moves"] == "train_env_steps_per_s"}


def test_banned_modules_compare_whole_top_level_names():
    run = _run_module()
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["high_speed_quadrupedal_locomotion_by_irrl_torch_x"] = sys
        assert "high_speed_quadrupedal_locomotion_by_irrl_tpu" not in run.banned_modules()
        sys.modules["high_speed_quadrupedal_locomotion_by_irrl_tpu.envs"] = sys
        assert run.banned_modules() == ["high_speed_quadrupedal_locomotion_by_irrl_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_a_card_a_cell_exits_with_no_result():
    if _has_card():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          "srb_fleet_8192", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cut_down_run_prints_its_line_and_loads_no_jax():
    over = json.dumps({"traffic": {"num_envs": 3, "n_steps": 4, "checked_steps": 2}})
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code, os.path.join(HERE, "run.py"),
                          "--workload", "srb_fleet_8192", "--seed", "2147483701",
                          "--seconds", "0.1", "--trace", "0", "--device", "cpu",
                          "--override", over],
                         capture_output=True, text=True, cwd=ROOT, timeout=900,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == RESULT_KEYS and list(line)[5:] == ["checks"]
    assert set(line["metrics"]) == {"mpc_robot_steps_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert "must not be loaded" not in out.stderr


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()
