"""``core/spans.py``: the device's idle time split over the program's host
spans, on synthetic events and spans; and each reader built on it, on a
synthetic traced run, and with nothing recorded."""

import importlib.util
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from irrl_bench.core import spans  # noqa: E402

MS = 1_000_000   # ns


def _metric(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ev(*pairs):
    return [("k", s * MS, e * MS) for s, e in pairs]


def _tree():
    """R [0, 100] holding A [10, 40] (step 0, holding A1 [20, 30]) and B
    [50, 90] (step 1); the device busy at [0, 5], [25, 28], [45, 60], [85, 95]."""
    sp = [("R", -1, None, 0, 100), ("A", 0, 0, 10, 40), ("A1", 1, 0, 20, 30),
          ("B", 0, 1, 50, 90)]
    rec = {"spans": [(n, p, s, a * MS, b * MS) for n, p, s, a, b in sp], "counts": []}
    return rec, _ev((0, 5), (25, 28), (45, 60), (85, 95))


def test_idle_goes_to_the_innermost_open_span_by_overlap():
    rec, events = _tree()
    a = spans.attribute(rec, events, "R")
    idle = {k: round(v["idle_s"] * 1e3, 6) for k, v in a["spans"].items()}
    # idle [5, 25], [28, 45], [60, 85], [95, 100]; [28, 45] straddles A1, A and R
    assert idle == {"R": 15.0, "A": 20.0, "A1": 7.0, "B": 25.0}
    assert a["idle_s"] == pytest.approx(0.067) and a["wall_s"] == pytest.approx(0.1)
    assert a["unattributed_share"] == pytest.approx(15 / 67)
    assert a["under"]("A") == pytest.approx(0.027) and a["under"]("B") == pytest.approx(0.025)
    assert a["steps"] == 2
    assert a["spans"]["A"]["host_ms_per_step"] == pytest.approx(15.0)
    assert a["spans"]["A"]["self_ms_per_step"] == pytest.approx(10.0)
    assert a["spans"]["R"]["self_ms_per_step"] == pytest.approx(15.0)


def test_events_outside_the_root_and_an_idle_device():
    rec, _ = _tree()
    a = spans.attribute(rec, _ev((-50, -10), (200, 300)), "R")
    assert a["idle_s"] == pytest.approx(0.1)
    assert sum(v["idle_s"] for v in a["spans"].values()) == pytest.approx(0.1)
    a = spans.attribute(rec, _ev((-5, 200)), "R")
    assert a["idle_s"] == 0.0 and a["unattributed_share"] == 0.0
    assert spans.attribute(rec, [], "nothing") is None


def test_the_step_clock_is_its_own_line():
    sp = [("mpc.rollout", -1, None, 0, 100), ("mpc.step", 0, 0, 0, 50),
          ("srb.make_problem", 1, 0, 10, 20), ("srb.solve", 1, 0, 20, 50),
          ("mpc.step", 0, 1, 50, 100), ("srb.make_problem", 4, 1, 70, 80)]
    rec = {"spans": [(n, p, s, a * MS, b * MS) for n, p, s, a, b in sp], "counts": []}
    a = spans.attribute(rec, _ev((0, 5), (30, 40), (50, 60)), "mpc.rollout")
    idle = {k: round(v["idle_s"] * 1e3, 6) for k, v in a["spans"].items()}
    assert idle == {"mpc.rollout": 0.0, spans.STEP_CLOCK: 15.0, "srb.make_problem": 20.0,
                    "srb.solve": 20.0, "mpc.step": 20.0}
    assert a["unattributed_share"] == 0.0
    assert a["spans"]["mpc.step"]["self_ms_per_step"] == pytest.approx(10.0)
    obs = {"profile": {"events": []}, "spans": rec}
    assert spans.host_durations_ms(obs, "mpc.rollout", "mpc.step") == [40.0, 30.0]


def _train_obs(steps=4):
    """A profiled update: per step ppo.policy 2 ms, env.step 6 ms (env.kernel
    1 ms inside), ppo.record 1 ms; 20 host copies a step under env.post's
    gait.reference and 3 outside the loop; the device busy only in env.kernel."""
    sp, counts, events = [("ppo.update", -1, None, 0, 0), ("ppo.rollout", 0, None, 0, 0)], [], []
    t = 0
    for k in range(steps):
        sp.append(("ppo.policy", 1, k, t, t + 2))
        env = len(sp)
        sp.append(("env.step", 1, k, t + 2, t + 8))
        sp.append(("env.kernel", env, k, t + 3, t + 4))
        post = len(sp)
        sp.append(("env.post", env, k, t + 4, t + 8))
        gait = len(sp)
        sp.append(("gait.reference", post, k, t + 5, t + 6))
        sp.append(("ppo.record", 1, k, t + 8, t + 9))
        counts.append(("host_copies", gait, k, 20))
        events.append(("phys_control_step_kernel", (t + 3) * MS, (t + 4) * MS))
        t += 10
    sp[0] = ("ppo.update", -1, None, 0, t + 10)
    sp[1] = ("ppo.rollout", 0, None, 0, t)
    counts.append(("host_copies", 0, None, 3))
    rec = {"spans": [(n, p, s, a * MS, b * MS) for n, p, s, a, b in sp], "counts": counts}
    return {"profile": {"events": events}, "spans": rec}


def test_training_readers_on_a_synthetic_update():
    obs = _train_obs()
    assert _metric("policy_host_ms.train").read(obs) == pytest.approx(2.0)
    assert _metric("env_step_host_ms.train").read(obs) == pytest.approx(6.0)
    # env.step's idle: 5 ms of its 6 a step (the kernel keeps the device busy 1 ms),
    # over the update's 50 ms
    assert _metric("idle_env_step.train").read(obs) == pytest.approx(100.0 * 20 / 50)
    assert _metric("host_copies_per_step.train").read(obs) == pytest.approx(20.0)


def _mpc_obs(steps=250):
    """A profiled rollout: each 10-ms step opens with 2 ms of the benchmark's
    clock, then make_problem 1 ms, solve 4 ms (busy the last 1 ms of it), the
    env step 3 ms; a step's host time is 8 ms, the last twenty steps' 18 ms."""
    sp, counts, events, t = [("mpc.rollout", -1, None, 0, 0)], [], [], 0
    for k in range(steps):
        d = 20 if k >= steps - 20 else 10
        st = len(sp)
        sp.append(("mpc.step", 0, k, t, t + d))
        sp.append(("srb.make_problem", st, k, t + 2, t + 3))
        solve = len(sp)
        sp.append(("srb.solve", st, k, t + 3, t + 7))
        sp.append(("env.step", st, k, t + 7, t + d))
        counts.append(("host_copies", solve, k, 2))
        counts.append(("host_copies", st, k, 6))
        events.append(("k", (t + 6) * MS, (t + 7) * MS))
        t += d
    sp[0] = ("mpc.rollout", -1, None, 0, t)
    rec = {"spans": [(n, p, s, a * MS, b * MS) for n, p, s, a, b in sp], "counts": counts}
    return {"profile": {"events": events}, "spans": rec}, t


def test_mpc_readers_on_a_synthetic_rollout():
    obs, wall = _mpc_obs()
    assert _metric("solve_host_ms.mpc").read(obs) == pytest.approx(4.0)
    assert _metric("idle_solve.mpc").read(obs) == pytest.approx(100.0 * 3 * 250 / wall)
    assert _metric("mpc_step_host_ms_p95").read(obs) == pytest.approx(18.0)
    assert _metric("host_copies_per_step.mpc").read(obs) == pytest.approx(8.0)
    short, _ = _mpc_obs(150)
    assert _metric("mpc_step_host_ms_p95").read(short) is None


NEW = ["policy_host_ms.train", "env_step_host_ms.train", "idle_env_step.train",
       "host_copies_per_step.train", "solve_host_ms.mpc", "idle_solve.mpc",
       "mpc_step_host_ms_p95", "host_copies_per_step.mpc"]


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_with_nothing_recorded(name):
    mod = _metric(name)
    assert mod.read({"profile": None}) is None
    assert mod.read({"profile": {"events": []}, "spans": None}) is None
    # a traced run of a program that recorded nothing: the reader takes an empty record
    from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling
    profiling.take()
    assert mod.read({"profile": {"events": []}}) is None
