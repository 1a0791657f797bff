"""The port's host tracer (``utils/profiling``): spans and counters recorded
only while a profiler window or ``recording()`` is open, on the profiler's
clock, with no PyTorch op of their own; and the span trees of the two hot
loops, the PPO update and the SRB-MPC rollout, one set a control step."""

import collections
import inspect
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as tdevice
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime as truntime
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def _paths(rec):
    """Counter of (step, path from the top) over the recorded spans."""
    out = collections.Counter()
    for s in rec.spans:
        names, p = [s.name], s.parent
        while p >= 0:
            names.append(rec.spans[p].name)
            p = rec.spans[p].parent
        out[(s.step, " > ".join(reversed(names)))] += 1
    return out


def test_spans_nest_with_parent_and_step():
    profiling.take()

    @profiling.span("t.fn")
    def fn(x, y=2):
        profiling.count("t.calls")
        return x + y

    assert list(inspect.signature(fn).parameters) == ["x", "y"]
    with profiling.recording():
        profiling.set_step(3)
        with profiling.span("t.a"):
            with profiling.span("t.b"):
                pass
            assert fn(1) == 3
        profiling.set_step(None)
        with profiling.span("t.c"):
            profiling.count("t.calls", 2)
    rec = profiling.take()
    assert [(s.name, s.parent, s.step) for s in rec.spans] == [
        ("t.a", -1, 3), ("t.b", 0, 3), ("t.fn", 0, 3), ("t.c", -1, None)]
    assert [tuple(c) for c in rec.counts] == [("t.calls", 2, 3, 1), ("t.calls", 3, None, 2)]
    assert all(s.t0_ns <= s.t1_ns for s in rec.spans)
    assert profiling.take().spans == []


def test_self_time_is_total_less_children():
    profiling.take()
    with profiling.recording():
        with profiling.span("t.outer"):
            time.sleep(0.01)
            with profiling.span("t.inner"):
                time.sleep(0.02)
            with profiling.span("t.inner"):
                time.sleep(0.005)
    outer, *inner = profiling.take().spans
    total = outer.t1_ns - outer.t0_ns
    children = sum(s.t1_ns - s.t0_ns for s in inner)
    assert all(outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns for s in inner)
    assert inner[0].t1_ns <= inner[1].t0_ns
    assert children >= 0.025e9 and total - children >= 0.01e9


def test_spans_and_counters_issue_no_ops_and_record_only_when_on():
    profiling.take()
    x = torch.ones(3)
    for on in (False, True):
        with _Ops() as ops:
            with profiling.recording() if on else _nothing():
                with profiling.span("t.op"):
                    profiling.count("t.n")
                    profiling.set_step(0)
                profiling.set_step(None)
        assert ops.calls == 0
        rec = profiling.take()
        assert (len(rec.spans), len(rec.counts)) == ((1, 1) if on else (0, 0))
    with _Ops() as ops:       # a torch op inside a span is counted, the span is not
        with profiling.span("t.op"):
            x + 1
    assert ops.calls == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("t.window"):
            pass
    assert [s.name for s in profiling.take().spans] == ["t.window"]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_spans_lie_on_the_profilers_clock(tmp_path):
    """A span and its own record_function event under the trace export start
    within a millisecond of each other: both are Unix-epoch nanoseconds."""
    profiling.take()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("t.warm"):
            pass
        for _ in range(5):
            with profiling.span("t.clock"):
                torch.ones(2) + 1
    spans = [s for s in profiling.take().spans if s.name == "t.clock"]
    events = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "t.clock")
    assert len(events) == len(spans) == 5
    for s, e in zip(spans, events):
        assert abs(e - s.t0_ns) < 1_000_000, (e, s.t0_ns)


def test_device_tensor_counts_host_data_only():
    profiling.take()
    dev = torch.device("cpu")
    with profiling.recording():
        tdevice.tensor(np.zeros(3), dev)
        tdevice.tensor([1.0, 2.0], dev)
        tdevice.tensor(torch.zeros(2), dev)        # a host tensor is host data too
    assert sum(c.n for c in profiling.take().counts if c.name == "host_copies") == 3


def test_ppo_update_records_its_span_tree_once_a_step():
    env_cfg = tconfig.train_default().replace(num_envs=3, use_lanes_physics=True)
    cfg = tppo.PPOConfig(n_lstm=(8, 8), n_steps=3, noptepochs=2)
    ts = tppo.init_train_state(env_cfg, cfg, 5, device="cpu")
    update = tppo.make_update_fn(env_cfg, cfg)
    profiling.take()
    with profiling.recording():
        update(ts)
    rec = profiling.take()
    paths = _paths(rec)
    step = {"ppo.update > ppo.rollout > ppo.policy": 1,
            "ppo.update > ppo.rollout > env.step": 1,
            "ppo.update > ppo.rollout > env.step > env.pre": 1,
            "ppo.update > ppo.rollout > env.step > env.kernel": 1,
            "ppo.update > ppo.rollout > env.step > env.post": 1,
            "ppo.update > ppo.rollout > env.step > env.post > gait.reference": 4,
            "ppo.update > ppo.rollout > ppo.record": 1}
    for t in range(3):
        assert {p: n for (s, p), n in paths.items() if s == t} == step
    outside = {p: n for (s, p), n in paths.items() if s is None}
    assert outside == {"ppo.update": 1, "ppo.update > ppo.rollout": 1, "ppo.update > ppo.gae": 1,
                       "ppo.update > ppo.gae > gait.reference": 3,
                       "ppo.update > ppo.epochs": 1,
                       "ppo.update > ppo.epochs > ppo.minibatch": 2,
                       "ppo.update > ppo.epochs > ppo.minibatch > lstm.sequence": 2,
                       "ppo.update > ppo.epochs > ppo.minibatch > ppo.backward": 2,
                       "ppo.update > ppo.epochs > ppo.minibatch > ppo.adam": 2}
    copies = collections.Counter()
    for c in rec.counts:
        assert c.name == "host_copies"
        copies[(c.step, rec.spans[c.span].name)] += c.n
    # from step 1 on (step 0 may fill constant caches) no copy from the host at all
    per_step = [{k[1]: n for k, n in copies.items() if k[0] == t} for t in (1, 2)]
    assert per_step == [{}, {}]


def test_mpc_rollout_records_its_span_tree_once_a_step():
    env, scfg, kw = truntime.speed_schedule(tconfig.test_default(), 1.0)
    cmds = np.array([[1.0, 0.0, 0.0], [1.5, 0.0, 0.0]], np.float32)
    profiling.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        truntime.mpc_rollout(env, scfg, cmds, torch.Generator(), 3, device="cpu", **kw)
    rec = profiling.take()
    paths = _paths(rec)
    step = {"mpc.rollout > mpc.step": 1,
            "mpc.rollout > mpc.step > srb.make_problem": 1,
            "mpc.rollout > mpc.step > srb.solve": 1,
            "mpc.rollout > mpc.step > srb.grf_to_torque": 1,
            "mpc.rollout > mpc.step > gait.reference": 1,
            "mpc.rollout > mpc.step > env.step": 1,
            "mpc.rollout > mpc.step > env.step > env.pre": 1,
            "mpc.rollout > mpc.step > env.step > env.kernel": 1,
            "mpc.rollout > mpc.step > env.step > env.post": 1,
            "mpc.rollout > mpc.step > mpc.log": 1}
    for t in range(3):
        assert {p: n for (s, p), n in paths.items() if s == t} == step
    assert {p: n for (s, p), n in paths.items() if s is None} == {"mpc.rollout": 1}
    copies = collections.Counter()
    for c in rec.counts:
        copies[(c.step, rec.spans[c.span].name)] += c.n
    # the gait's and the leg kinematics' constants are cached: no copy from the host a step
    per_step = [{k[1]: n for k, n in copies.items() if k[0] == t} for t in (1, 2)]
    assert per_step == [{}, {}]
