"""The benchmark's plain reference agrees with the port's plain twins at a tiny
size on the CPU, and imports nothing of the port."""

import ast
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime, srb  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_cuda  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import pd_torque  # noqa: E402

from irrl_bench.core import compare, port  # noqa: E402
from irrl_bench.reference import physics as ref_phys  # noqa: E402
from irrl_bench.reference import policy as ref_pol  # noqa: E402
from irrl_bench.reference import ppo as ref_ppo  # noqa: E402
from irrl_bench.reference import srb as ref_srb  # noqa: E402

CKPT = os.path.join(ROOT, "artifacts", "irrl_tpu_relaxed_4e8")
CONFIG = __import__("json").load(open(os.path.join(HERE, "configs", "irrl_bp5_lstm.json")))
MPC_CONFIG = __import__("json").load(open(os.path.join(HERE, "configs", "srb_trot_mpc.json")))


def test_the_reference_imports_nothing_of_the_port():
    for name in os.listdir(os.path.join(HERE, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(HERE, "reference", name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top in ("__future__", "contextlib", "typing", "math", "os", "numpy",
                               "torch", "irrl_bench"), (name, m)
                assert not m.startswith("irrl_bench") or m.startswith("irrl_bench.reference")


def _states(which: str, B: int, seed: int):
    env = port.env_config(CONFIG, which, B)
    g = torch.Generator().manual_seed(seed)
    st = bp.env_init(env, B, g, "cpu")
    gv = st.gv + 0.5 * torch.randn(B, 18, generator=g)
    ptarget = st.gc[:, 7:] + 0.2 * torch.randn(B, 12, generator=g)
    return env, st, gv, ptarget, torch.randn(B, 12, generator=g), g


@pytest.mark.parametrize("which,c2t", [("train_env", False), ("test_env", False),
                                       ("test_env", True)])
def test_physics_matches_the_plain_control_step(which, c2t):
    env, st, gv, ptarget, tnl, g = _states(which, 5, 11)
    contact = dict(CONFIG["contact"], contact_impulse_mass=2.0 if c2t else 0.0)
    env = env.replace(contact_impulse_mass=contact["contact_impulse_mass"])
    B = gv.shape[0]
    ff = 3.0 * torch.randn(B, 12, generator=g) if c2t else None
    ps = torch.rand(B, 12, generator=g) if c2t else None
    wrench = torch.zeros(B, 6)
    rows = lambda x: None if x is None else x.T.contiguous()  # noqa: E731
    out = phys_cuda.control_step(phys_lanes.params_to_lanes(st.params), pd_torque.from_config(env),
                                 st.gc.T.contiguous(), gv.T.contiguous(), ptarget.T.contiguous(),
                                 tnl.T.contiguous(), wrench.T.contiguous(), env.substeps,
                                 env.contact_slip_vel,
                                 env.contact_impulse_mass / env.simulation_dt, env.simulation_dt,
                                 rows(ff), rows(ps))
    p = st.params
    robot = ref_phys.Robot(p.mass, p.com, p.inertia, p.joint_origin, p.friction,
                           p.contact_stiffness, p.contact_damping)
    s = ref_phys.settings(CONFIG[which], contact, "cpu")
    gc2, gv2, _ = ref_phys.control_step(robot, s, st.gc, gv, ptarget, tnl, wrench, ff, ps)
    got = torch.cat([out[0].T, out[1].T], -1)
    want = torch.cat([gc2, gv2], -1)
    assert float(compare.state_gaps(got, want, torch.cat([st.gc, gv], -1)).max()) < 1e-3


def _policy_inputs(B: int, T: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn(T, B, 35, generator=g)
    dones = (torch.rand(T, B, generator=g) < 0.2).float()
    state = 0.3 * torch.randn(B, 4 * 96, generator=g)
    return obs, dones, state


def test_policy_step_and_sequence_match_the_plain_cells():
    params = mio.load_bp5_csv(CKPT, device="cpu")
    w = ref_pol.load_csv(CKPT, 2, "cpu")
    obs, dones, state = _policy_inputs(6, 5, 3)
    got = lstm.forward(params, obs[0], state, dones[0])
    want = ref_pol.step(w, obs[0], state, dones[0])
    for a, b in ((got.mean, want.mean), (got.value, want.value), (got.state, want.state)):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-6)
    with torch.no_grad():
        got = lstm.sequence(params, obs, dones, state)
    want = ref_pol.sequence(w, obs, dones, state)
    torch.testing.assert_close(got.mean, want.mean, atol=2e-6, rtol=1e-6)
    torch.testing.assert_close(got.value, want.value, atol=2e-6, rtol=1e-6)


def test_three_optimizer_steps_match_the_port():
    T, B = 6, 4
    obs, dones, state = _policy_inputs(B, T, 5)
    g = torch.Generator().manual_seed(9)
    batch = ppo.Batch(obs=obs, actions=torch.randn(T, B, 12, generator=g),
                      values=torch.randn(T, B, generator=g),
                      neglogpacs=10.0 + torch.randn(T, B, generator=g),
                      returns=torch.randn(T, B, generator=g), dones_before=dones,
                      rewards=torch.zeros(T, B), init_lstm_state=state)
    cfg = port.ppo_config(CONFIG, T)
    params = mio.load_bp5_csv(CKPT, device="cpu").requires_grad_()
    opt = ppo.make_optimizer(cfg, params)
    losses = [float(ppo.train_minibatch(params, opt, batch, cfg)["loss"]) for _ in range(3)]
    w = ref_pol.load_csv(CKPT, 2, "cpu")
    ref = ref_ppo.train_steps(w, ref_ppo.Batch(obs, batch.actions, batch.values,
                                               batch.neglogpacs, batch.returns, dones, state),
                              CONFIG["ppo"], 3, block=3)
    for a, b in zip(losses, ref.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, p in params.named_leaves():
        torch.testing.assert_close(p.detach(), ref.params[-1][name], atol=1e-6, rtol=1e-5)


def test_srb_problem_solve_and_torques_match_the_port():
    B = 5
    env = port.env_config({"env": MPC_CONFIG["env"], "contact": {}}, "env", B)
    env_cfg, scfg, kwargs = runtime.high_speed_setup(env)
    g = torch.Generator().manual_seed(4)
    st = bp.env_init(env_cfg.replace(manual=True), B, g, "cpu")
    gc = st.gc.clone()
    gc[:, 3:7] = torch.nn.functional.normalize(gc[:, 3:7] + 0.05 * torch.randn(B, 4,
                                                                              generator=g), dim=-1)
    gv = 0.3 * torch.randn(B, 18, generator=g)
    cmd = torch.stack([0.5 + 2.9 * torch.rand(B, generator=g), torch.zeros(B), torch.zeros(B)], -1)
    t0 = 0.2 * torch.rand(B, generator=g)
    prob = srb.make_problem(env_cfg, gc, gv, cmd, t0)
    want = ref_srb.make_problem(gc, gv, cmd, t0)
    for a, b in zip(prob, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    res = srb.solve(env_cfg, scfg, prob, controls=False)
    s = ref_srb.settings(MPC_CONFIG["env"], MPC_CONFIG["srb"])
    mass, inertia = ref_srb.body_constants("cpu")
    sol = ref_srb.solve(s, ref_srb.Problem(*prob), mass, inertia)
    assert compare.widest(res.forces, sol.forces, compare.rms(sol.forces)) < 1e-4
    assert compare.widest(res.cost, sol.cost, compare.rms(sol.cost)) < 1e-4
    sm = srb.stance_mask(env_cfg, t0)
    got = srb.grf_to_torque(env_cfg, gc, res.forces[:, 0], sm, kwargs["stance_pd"],
                            kwargs["swing_pd"])
    ref = ref_srb.grf_to_torque(gc, res.forces[:, 0], ref_srb.stance(s, t0), kwargs["stance_pd"],
                                kwargs["swing_pd"])
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], ref[1], atol=0, rtol=0)


def test_yaml_mapping_builds_the_ports_configs():
    train = cfg_mod.from_yaml(os.path.join(ROOT, "high_speed_quadrupedal_locomotion_by_irrl_torch",
                                           "configs", "bp5_train.yaml"))
    assert port.env_config(CONFIG, "train_env", train.num_envs) == train
