"""PyTorch port: the env step's post-physics work as a CUDA graph
(``envs/post_graph``) on the CPU, where it does not engage: the eager
fallback on CPU tensors and under autograd, the argument trees it copies in
and out, the per-env step's own path, and the constant caches of the gait and
the leg kinematics, which leave the step no copy from the host once filled.
The replays themselves are held to the eager step on the card
(``tests/test_torch_kernels.py``)."""

import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as tbp
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import post_graph
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import gait as tgait
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import kinematics as tkin
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling

torch.set_num_threads(1)


def _post_args(monkeypatch, B=3, seed=0):
    """The arguments of one ``step_batch``'s post-physics call under the
    training config (observation noise, resets and commands drawn), and the
    generator's state before it."""
    cfg = tconfig.train_default().replace(num_envs=B, use_lanes_physics=True)
    gen = torch.Generator().manual_seed(seed)
    state = tbp.env_init(cfg, B, gen, "cpu")
    got = {}

    def keep(*args):
        got["args"], got["gen_state"] = args, gen.get_state()
        return tbp._post_substeps(*args)
    with monkeypatch.context() as m:
        m.setattr(tbp, "_post_graphs", keep)
        tbp.step_batch(cfg, state, torch.full((B, 12), 0.3), gen)
    return got["args"], got["gen_state"]


def _leaves(tree):
    out = []
    post_graph._flatten(tree, out)
    return out


def _assert_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert post_graph._flatten(got, []) == post_graph._flatten(want, [])
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


@pytest.mark.parametrize("grad", [False, True])
def test_wrapper_runs_the_step_eagerly_on_the_cpu_and_under_grad(monkeypatch, grad):
    """Called three times (as often as a warm-up, a capture and a replay
    would take) on CPU tensors, one of them requiring grad or none, the
    wrapper gives exactly ``_post_substeps``'s outputs and draws as many
    numbers; it keeps no key and counts neither a capture nor a replay."""
    args, gen_state = _post_args(monkeypatch)
    cfg, state, gen, gc = args[:4]
    if grad:
        args = args[:3] + (gc.clone().requires_grad_(),) + args[4:]
    gen.set_state(gen_state)
    want = tbp._post_substeps(*args)
    want_gen = gen.get_state()
    w = post_graph.PostGraphs(tbp._post_substeps)
    profiling.take()
    with profiling.recording():
        for _ in range(3):
            gen.set_state(gen_state)
            got = w(*args)
            _assert_equal(got, want)
            assert torch.equal(gen.get_state(), want_gen)
    rec = profiling.take()
    assert not [c for c in rec.counts if c.name.startswith("post_graph")]
    assert not w._graphs
    # the eager call's own span tree: env.post with the step's and reset's references
    names = [s.name for s in rec.spans]
    assert names.count("env.post") == 3 and names.count("gait.reference") == 12


def test_argument_trees_rebuild_the_same_objects(monkeypatch):
    """What the wrapper flattens (the state with its robot parameters, the
    kernel's outputs, the pre-physics tuple, the step's output with its info
    dict) rebuilds to equal trees around the same tensors, in order; the
    spec is hashable, and a leaf spec is not mistaken for a value."""
    args, _ = _post_args(monkeypatch)
    out = tbp._post_substeps(*args)
    for tree in (args[1:], out):
        leaves = []
        spec = post_graph._flatten(tree, leaves)
        hash(spec)
        back = post_graph._build(spec, iter(leaves))
        assert type(back) is type(tree)
        again = []
        assert post_graph._flatten(back, again) == spec
        assert all(a is b for a, b in zip(leaves, again)) and len(leaves) == len(again)
    assert type(out.state.params) is type(args[1].params) and out.info.keys() == {
        "reward_terms", "ep_return", "ep_len", "base_height", "contact"}
    assert post_graph._build(post_graph._flatten(("tensor", None, 2.5), []), iter([])) == (
        "tensor", None, 2.5)


def test_copy_groups_split_by_dtype_and_layout():
    f, i = torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32)
    dst = [f, i, f.clone(), torch.zeros(4, 3), i.clone()]
    src = [f, i, f, torch.zeros(3, 4).T, i]
    assert post_graph._groups(dst, src) == [[0, 2], [1, 4], [3]]


def test_per_env_step_keeps_its_own_post_call(monkeypatch):
    """``step`` (the per-env physics) calls ``_post_substeps`` itself, never
    the graph wrapper; both steps record env.post with its four gait
    references (the step's own and reset's three)."""
    cfg = tconfig.train_default().replace(num_envs=2)
    trees = {}
    for fn in (tbp.step, tbp.step_batch):
        gen = torch.Generator().manual_seed(1)
        state = tbp.env_init(cfg, 2, gen, "cpu")
        with monkeypatch.context() as m:
            if fn is tbp.step:
                m.setattr(tbp, "_post_graphs", None)     # a call would raise
            profiling.take()
            with profiling.recording():
                fn(cfg, state, torch.zeros(2, 12), gen)
        rec = profiling.take()
        trees[fn.__name__] = sorted(
            (rec.spans[s.parent].name if s.parent >= 0 else "", s.name) for s in rec.spans)
    assert trees["step"] == sorted([("", "env.step"), ("env.step", "env.pre"),
                                    ("env.step", "env.post")]
                                   + [("env.post", "gait.reference")] * 4)
    assert trees["step_batch"] == sorted(trees["step"] + [("env.step", "env.kernel")])


_B = 5
_GAIT_CALLS = {
    "toe_targets": lambda cfg, cmd, t: tgait.toe_targets(cfg, cmd, t),
    "raibert_weight": lambda cfg, cmd, t: tgait.raibert_weight(cfg, t),
    "gait_reference": lambda cfg, cmd, t: tgait.gait_reference(cfg, cmd, t),
    "legs_ik": lambda cfg, cmd, t: tkin.legs_ik(tgait.toe_targets(cfg, cmd, t)),
    "legs_fk": lambda cfg, cmd, t: tkin.legs_fk(torch.zeros(_B, 12)),
    "legs_jacobian": lambda cfg, cmd, t: tkin.legs_jacobian(torch.zeros(_B, 12)),
}


@pytest.mark.parametrize("name", list(_GAIT_CALLS))
def test_gait_and_kinematics_copy_their_constants_once(name):
    """The first call after the caches are emptied copies the constants from
    the host (counted as ``host_copies``); a second call on the same device
    copies nothing."""
    cfg = tconfig.train_default().replace(lean_front=0.01 * len(name))
    cmd = torch.tensor([[1.0, 0.1, 0.2]] * _B)
    t = torch.linspace(0.0, 0.3, _B)
    call = _GAIT_CALLS[name]
    tgait._consts.cache_clear()
    tkin._is_right.cache_clear()
    copies = []
    for _ in range(2):
        profiling.take()
        with profiling.recording():
            call(cfg, cmd, t)
        copies.append(sum(c.n for c in profiling.take().counts if c.name == "host_copies"))
    assert copies[0] > 0 and copies[1] == 0
