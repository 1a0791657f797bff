"""PyTorch port: data-parallel training and sharded solves over two gloo
processes (parallel/, algo/ppo with a mesh, cli/train.py --distributed).

The ranks are this file run as a script (``python tests/test_torch_distributed.py
RANK PORT DIR``), on localhost with the gloo backend, brought up through
``init_distributed``'s JAX signature; the ``cli.train`` runs come up from the
launcher's environment (world 2) and from nothing (world 1). Everything they
compute is checked here against one process of the port and the JAX package:

- JAX's two-process test (tests/test_distributed.py) mirrored: batch 8 through
  the LSTM policy, loss and gradient sum against one process and JAX's;
- epochs on a fixed batch split over the ranks: with one minibatch against
  JAX's ``ppo_loss`` gradients under optax's clip and Adam, with four (ranks
  that own no env of a minibatch) against the port's one process;
- one full update at world 2 against world 1 on the lanes and the per-env
  physics (16 envs, obs noise on): the rollout block for block, metrics and
  parameters within JAX's rtol 2e-4 (tests/test_parallel.py:33), the
  parameters bit for bit alike on the ranks;
- the sharded SRB and whole-body solves against the unsharded ones.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as tdev
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb as tsrb
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import trot as ttrot
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import mesh as tmesh
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import train as tptrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as tmdl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 300
RTOL = 2e-4                  # JAX's sharded-against-local limit (tests/test_parallel.py:33)
EPOCH_T, EPOCH_B, EPOCH_LSTM = 8, 8, (16, 16)
CLI = ["-m", "high_speed_quadrupedal_locomotion_by_irrl_torch.cli.train", "--distributed",
       "--device", "cpu", "--num-envs", "4", "--n-steps", "8", "--max-updates", "1",
       "--seed", "3"]
UPDATE_PATHS = ("lanes", "perenv")


# --- inputs, made alike by the ranks and the test ----------------------------

def lstm_obs(B: int = 8) -> np.ndarray:
    """tests/test_distributed.py's batch."""
    return (np.arange(B * 35, dtype=np.float32).reshape(B, 35) % 7) / 7.0


def lstm_loss_sum(params, obs: torch.Tensor, n: int) -> torch.Tensor:
    """The part of JAX's ``mean(value**2) + mean(mean**2)`` over ``n`` rows
    that the rows of ``obs`` hold (all of it when they are all ``n``)."""
    B = obs.shape[0]
    out = tlstm.forward(params, obs, torch.zeros(B, tlstm.state_size((48, 48))), torch.zeros(B))
    return (out.value ** 2).sum() / n + (out.mean ** 2).sum() / (n * out.mean.shape[-1])


def lstm_grads(params, loss: torch.Tensor) -> list:
    """d loss / d every leaf (zeros where a leaf does not enter, as JAX gives)."""
    grads = torch.autograd.grad(loss, params.leaves(), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params.leaves(), grads)]


def epoch_inputs(seed: int = 11):
    """Parameters, Adam's moments (count 7, not fresh) and a rollout-like
    batch, from numpy, as tests/test_torch_ppo.py makes them."""
    rng = np.random.default_rng(seed)
    blank = tlstm.init(torch.Generator().manual_seed(0), n_lstm=EPOCH_LSTM, device="cpu")
    flat = {k: (0.3 * rng.normal(size=tuple(t.shape))).astype(np.float32)
            for k, t in blank.named_leaves()}
    flat["logstd"] = np.full(12, -0.5, np.float32) + 0.1 * flat["logstd"]
    mu = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    nu = {k: (1e-4 * rng.random(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    T, B = EPOCH_T, EPOCH_B
    batch = dict(obs=f(T, B, 35), actions=0.5 * f(T, B, 12), values=f(T, B),
                 neglogpacs=5.0 + f(T, B), returns=f(T, B),
                 dones_before=(rng.random((T, B)) < 0.2).astype(np.float32),
                 rewards=f(T, B), init_lstm_state=0.5 * f(B, 4 * sum(EPOCH_LSTM)))
    return flat, mu, nu, batch


def epoch_run(nmb: int, mesh=None, max_grad_norm: float = 0.05):
    """3 epochs of ``nmb`` minibatches on the batch (a rank's block of it
    with ``mesh``): (parameters, Adam state, each epoch's metrics)."""
    flat, mu, nu, data = epoch_inputs()
    params = tio.policy_params_from_numpy(flat, device="cpu").requires_grad_()
    cfg = tppo.PPOConfig(n_lstm=EPOCH_LSTM, noptepochs=3, nminibatches=nmb,
                         max_grad_norm=max_grad_norm, learning_rate=3e-3)
    opt = tppo.make_optimizer(cfg, params)
    assert tio.adam_state_from_numpy(opt, params, {"mu": mu, "nu": nu, "count": 7})
    lo, hi = (0, EPOCH_B) if mesh is None else tmesh.block(mesh, EPOCH_B)
    batch = tppo.Batch(**{k: torch.from_numpy(v[lo:hi] if k == "init_lstm_state" else v[:, lo:hi])
                          for k, v in data.items()})
    gen = torch.Generator().manual_seed(4)
    epochs = tppo.train_epochs(params, opt, batch, cfg,
                               gen if mesh is None else tdev.RankBlock(gen, lo, hi, EPOCH_B),
                               EPOCH_B, mesh)
    return (tio.policy_params_to_numpy(params), tio.adam_state_to_numpy(opt, params),
            [{k: float(v) for k, v in e.items()} for e in epochs])


def update_cfgs(path: str):
    env = tconfig.train_default().replace(num_envs=16, use_lanes_physics=path == "lanes")
    return env, tppo.PPOConfig(n_steps=3, noptepochs=2, nminibatches=2, n_lstm=(8, 8))


def update_run(path: str, mesh=None):
    """One update of 16 envs (a rank's shard with ``mesh``): (the rollout's
    batch, metrics, parameters)."""
    env_cfg, ppo_cfg = update_cfgs(path)
    ts = tppo.init_train_state(env_cfg, ppo_cfg, 7, device="cpu")
    if mesh is None:
        update = tppo.make_update_fn(env_cfg, ppo_cfg)
    else:
        ts = tptrain.shard_train_state(mesh, ts)
        update = tptrain.make_distributed_update(env_cfg, ppo_cfg, mesh)
    batches, rollout = [], tppo.rollout

    def kept(*a, **k):
        out = rollout(*a, **k)
        batches.append(out[1])
        return out
    tppo.rollout = kept
    try:
        ts, metrics = update(ts)
    finally:
        tppo.rollout = rollout
    return (batches[0], {k: float(v) for k, v in metrics.items() if not k.startswith("time_")},
            tio.policy_params_to_numpy(ts.params))


def srb_inputs():
    """tests/test_parallel.py's problems: 16 standing starts, horizon 8."""
    cfg = tconfig.test_default()
    cmds = torch.stack([torch.tensor([0.5 + 0.25 * i, 0.0, 0.0]) for i in range(16)])
    return cfg, tsrb.SRBConfig(horizon=8), tsrb.standing_problem(cfg, cmds)


def mpc_inputs():
    """4 whole-body problems from the stand, horizon 4, 2 iterations, one robot."""
    cfg = tconfig.test_default()
    x0 = ttrot.standing_x0(cfg, "cpu")
    cmds = torch.tensor([[0.5 + 0.5 * i, 0.0, 0.0] for i in range(4)])
    probs = ttrot.make_problem(cfg, x0[:19].expand(4, 19), x0[19:].expand(4, 18), cmds,
                               torch.zeros(4), 4)
    return cfg, ttrot.MPCConfig(horizon=4, n_iter=2), tmdl.nominal_params(cfg, "cpu"), probs


# --- the rank side -----------------------------------------------------------

def _rank_main(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    assert tmesh.init_distributed(f"127.0.0.1:{port}", WORLD, rank)
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.world, mesh.rank, mesh.backend) == (WORLD, rank, "gloo")
    arrays, rec = {}, {}

    # JAX's two-process test: the JAX package's initial weights, batch 8
    params = tio.policy_params_from_numpy(dict(np.load(os.path.join(out_dir, "lstm.npz"))),
                                          device="cpu").requires_grad_()
    lo, hi = tmesh.block(mesh, 8)
    loss = lstm_loss_sum(params, torch.from_numpy(lstm_obs()[lo:hi]), 8)
    grads = tmesh.all_reduce_sum(mesh, torch.cat([g.flatten() for g in lstm_grads(params, loss)]))
    rec["lstm"] = {"loss": float(tmesh.all_reduce_sum(mesh, loss.detach())),
                   "grad_abs_sum": float(grads.double().abs().sum())}

    for nmb in (1, 4):
        p, adam, epochs = epoch_run(nmb, mesh)
        arrays.update({f"epochs{nmb}.{k}": v for k, v in p.items()})
        arrays.update({f"epochs{nmb}.mu.{k}": v for k, v in adam["mu"].items()})
        arrays.update({f"epochs{nmb}.nu.{k}": v for k, v in adam["nu"].items()})
        rec[f"epochs{nmb}"] = {"metrics": epochs, "count": adam["count"]}

    for path in UPDATE_PATHS:
        batch, metrics, p = update_run(path, mesh)
        arrays.update({f"{path}.batch.{k}": v.numpy() for k, v in batch._asdict().items()})
        arrays.update({f"{path}.params.{k}": v for k, v in p.items()})
        rec[path] = {"metrics": metrics, "checksum": tmesh.checksum(
            [torch.from_numpy(p[k]) for k in sorted(p)])}

    cfg, scfg, probs = srb_inputs()
    res = tptrain.make_distributed_srb(cfg, scfg, mesh)(probs)
    arrays.update({f"srb.{k}": v.numpy() for k, v in res._asdict().items() if v is not None})
    cfg, mcfg, robot, probs = mpc_inputs()
    res = tptrain.make_distributed_mpc(cfg, mcfg, mesh)(robot, probs)
    arrays.update({f"mpc.{k}": v.numpy() for k, v in res._asdict().items()})

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    tmesh.shutdown()


# --- the test side -----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    return {**env, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", **kw}


class Procs:
    """Processes started together; :meth:`wait` once for all of them."""

    def __init__(self, cmds: list, envs: list):
        self.procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, env=e, cwd=REPO) for c, e in zip(cmds, envs)]
        self.outs = None

    def wait(self) -> list:
        if self.outs is None:
            try:
                self.outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, out in zip(self.procs, self.outs):
                assert p.returncode == 0, f"a process exited {p.returncode}:\n{out}"
        return self.outs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two ranks of this file and the world-1 and world-2
    ``cli.train --distributed`` runs at once; each test computes its
    reference before it waits for them."""
    import jax

    from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm
    d = tmp_path_factory.mktemp("ranks")
    jp = jlstm.init(jax.random.PRNGKey(0), 35, 12, (48, 48))
    np.savez(d / "lstm.npz", **tio.policy_params_to_numpy(
        tio.policy_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")))
    port, cli_port = _free_port(), _free_port()
    ranks = Procs([[sys.executable, __file__, str(r), str(port), str(d)] for r in range(WORLD)],
                  [_env()] * WORLD)
    cli1 = Procs([[sys.executable] + CLI + ["--log-dir", str(d / "cli1")]], [_env()])
    cli2 = Procs([[sys.executable] + CLI + ["--log-dir", str(d / "cli2")]] * WORLD,
                 [_env(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(cli_port))
                  for r in range(WORLD)])
    try:
        yield {"dir": d, "ranks": ranks, "cli1": cli1, "cli2": cli2, "jp": jp}
    finally:
        for p in (ranks, cli1, cli2):
            p.kill()


def _ranks(runs) -> list:
    """Each rank's (arrays, record)."""
    runs["ranks"].wait()
    d = runs["dir"]
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.json") as f:
            out.append((dict(np.load(d / f"rank{r}.npz")), json.load(f)))
    return out


def _prefixed(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _params_of(arrays: dict, prefix: str) -> dict:
    """The parameter leaves under ``prefix`` (not Adam's moments)."""
    return {k: v for k, v in _prefixed(arrays, prefix).items() if not k.startswith(("mu.", "nu."))}


def _assert_leaves(got: dict, want: dict, atol: float, rtol: float = 0.0):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)


def test_two_process_lstm_gradient_matches_one_process_and_jax(runs):
    """tests/test_distributed.py:83 in the port: both ranks hold the sum of
    their halves, equal to one process's loss and gradient and to JAX's."""
    import jax
    import jax.numpy as jnp

    from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm
    jp, obs = runs["jp"], lstm_obs()

    def jloss(p, o):
        out = jlstm.forward(p, o, jnp.zeros((8, jlstm.state_size((48, 48)))), jnp.zeros((8,)))
        return jnp.mean(out.value ** 2) + jnp.mean(out.mean ** 2)
    jval, jg = jax.value_and_grad(jloss)(jp, jnp.asarray(obs))
    want_jax = (float(jval), sum(float(jnp.sum(jnp.abs(x))) for x in jax.tree.leaves(jg)))
    params = tio.policy_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu").requires_grad_()
    loss = lstm_loss_sum(params, torch.from_numpy(obs), 8)
    want_port = (loss.item(), sum(float(g.double().abs().sum()) for g in lstm_grads(params, loss)))
    got = [(rec["lstm"]["loss"], rec["lstm"]["grad_abs_sum"]) for _, rec in _ranks(runs)]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want_port, rtol=1e-5)
    np.testing.assert_allclose(got[0], want_jax, rtol=1e-5)


def test_distributed_epochs_on_a_fixed_batch_match_optax(runs):
    """3 epochs of one minibatch, its 8 envs split over the ranks, from an
    Adam state that is not fresh, with the gradient norm above the clip:
    parameters, Adam's moments and each epoch's loss against JAX's
    ``ppo_loss`` gradients under optax (tests/test_torch_ppo.py's limits)."""
    import jax
    import jax.numpy as jnp
    import optax

    from high_speed_quadrupedal_locomotion_by_irrl_tpu.algo import ppo as jppo
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm
    flat, mu, nu, data = epoch_inputs()

    def jtree(leaves: dict):
        stack = lambda t: tuple(jlstm.LSTMWeights(*(jnp.asarray(leaves[f"{t}.{i}.{k}"])  # noqa: E731
                                                    for k in ("wx", "wh", "b")))
                                for i in range(len(EPOCH_LSTM)))
        return jlstm.PolicyParams(pi_lstm=stack("pi_lstm"), v_lstm=stack("v_lstm"),
                                  **{k: jnp.asarray(leaves[k])
                                     for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")})
    jcfg = jppo.PPOConfig(n_lstm=EPOCH_LSTM, max_grad_norm=0.05, learning_rate=3e-3)
    jb = jppo.Batch(**{k: jnp.asarray(v) for k, v in data.items()})
    jp, jopt = jtree(flat), jppo.make_optimizer(jcfg)
    st = jopt.init(jp)
    clip_state, (adam, *rest) = st.inner_state
    st = st._replace(inner_state=(clip_state, (adam._replace(
        count=jnp.asarray(7, jnp.int32), mu=jtree(mu), nu=jtree(nu)), *rest)))

    @jax.jit
    def jstep(params, st):
        (loss, _), grads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(params, jb, jcfg)
        updates, st = jopt.update(grads, st, params)
        return optax.apply_updates(params, updates), st, loss, optax.global_norm(grads)
    losses = []
    for _ in range(3):
        jp, st, jloss, jnorm = jstep(jp, st)
        assert float(jnorm) > 0.05
        losses.append(float(jloss))
    jadam = st.inner_state[1][0]
    flat_of = lambda t: tio.policy_params_to_numpy(  # noqa: E731
        tio.policy_params_from_numpy(jax.tree.map(np.asarray, t), device="cpu"))
    for arrays, rec in _ranks(runs):
        np.testing.assert_allclose([e["loss"] for e in rec["epochs1"]["metrics"]], losses,
                                   atol=1e-5, rtol=1e-4)
        assert rec["epochs1"]["count"] == int(jadam.count) == 10
        _assert_leaves(_params_of(arrays, "epochs1."), flat_of(jp), atol=1e-5)
        _assert_leaves(_prefixed(arrays, "epochs1.mu."), flat_of(jadam.mu), atol=1e-6, rtol=1e-4)
        _assert_leaves(_prefixed(arrays, "epochs1.nu."), flat_of(jadam.nu), atol=1e-8, rtol=1e-3)


def test_distributed_epochs_with_ranks_that_own_no_env_match_one_process(runs):
    """Four minibatches of 2 of the 8 envs: some minibatch lies in one rank's
    block, so the other joins its collectives with zeros and no forward. The
    ranks end bit for bit alike and within 1e-6 of one process's epochs."""
    gen = torch.Generator().manual_seed(4)
    perms = [torch.randperm(EPOCH_B, generator=gen).reshape(4, -1) for _ in range(3)]
    assert any(bool(((idx < EPOCH_B // 2).all() | (idx >= EPOCH_B // 2).all()))
               for perm in perms for idx in perm), "no rank went without members"
    params, adam, epochs = epoch_run(4)
    (a0, r0), (a1, r1) = _ranks(runs)
    for k in _prefixed(a0, "epochs4."):
        assert np.array_equal(a0["epochs4." + k], a1["epochs4." + k]), k
    assert r0["epochs4"] == r1["epochs4"] and r0["epochs4"]["count"] == adam["count"] == 19
    _assert_leaves(_params_of(a0, "epochs4."), params, atol=1e-6)
    _assert_leaves(_prefixed(a0, "epochs4.mu."), adam["mu"], atol=1e-7, rtol=1e-4)
    for g, w in zip(r0["epochs4"]["metrics"], epochs):
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("path", UPDATE_PATHS)
def test_one_update_at_world_2_equals_world_1(runs, path):
    """One update of 16 envs (3 steps, obs noise and domain randomization
    on, 2 epochs of 2 minibatches), world 2 against world 1: each rank's
    rollout is the block of world 1's, bit for bit; the metrics and every
    parameter within rtol 2e-4 (each leaf against its largest entry); the
    ranks' parameters bit for bit alike."""
    env_cfg, _ = update_cfgs(path)
    assert env_cfg.obs_noise > 0 and env_cfg.stochastic_dynamics
    batch, metrics, params = update_run(path)
    ranks = _ranks(runs)
    assert ranks[0][1][path]["checksum"] == ranks[1][1][path]["checksum"]
    for r, (arrays, rec) in enumerate(ranks):
        lo, hi = 8 * r, 8 * (r + 1)
        for k, v in batch._asdict().items():
            want = v[lo:hi] if k == "init_lstm_state" else v[:, lo:hi]
            assert np.array_equal(arrays[f"{path}.batch.{k}"], want.numpy()), (r, k)
        got = rec[path]["metrics"]
        assert got.keys() == metrics.keys()
        np.testing.assert_allclose([got[k] for k in metrics], list(metrics.values()),
                                   rtol=RTOL, atol=1e-7)
        for k, want in params.items():
            np.testing.assert_allclose(arrays[f"{path}.params.{k}"], want, rtol=0,
                                       atol=RTOL * np.abs(want).max(), err_msg=k)


def test_sharded_solves_match_the_unsharded_ones(runs):
    """make_distributed_srb on JAX's 16 standing problems x horizon 8 within
    tests/test_parallel.py:59-62's limits, and make_distributed_mpc on 4
    whole-body problems x h4 x 2 iterations, against the unsharded solves."""
    cfg, scfg, probs = srb_inputs()
    srb = tsrb.batched_solve(cfg, scfg, probs)
    cfg, mcfg, robot, mprobs = mpc_inputs()
    wb = ttrot.batched_solve(cfg, mcfg, robot, mprobs)
    for arrays, _ in _ranks(runs):
        np.testing.assert_allclose(arrays["srb.cost"], srb.cost.numpy(), rtol=1e-5)
        np.testing.assert_allclose(arrays["srb.us"], srb.us.numpy(), atol=1e-5)
        np.testing.assert_allclose(arrays["srb.forces"], srb.forces.numpy(), atol=1e-4)
        for k in ("cost", "cost_trace"):
            np.testing.assert_allclose(arrays[f"mpc.{k}"], getattr(wb, k).numpy(), rtol=1e-5)
        np.testing.assert_allclose(arrays["mpc.us"], wb.us.numpy(), atol=1e-5)


def test_cli_distributed_at_world_1_and_2(runs):
    """cli.train --distributed at world 1 (no launcher variables: a local
    store) and world 2 (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): one run
    directory each, written by rank 0, and the same final parameters."""
    outs1, outs2 = runs["cli1"].wait(), runs["cli2"].wait()
    assert "multi-GPU: 1 ranks over gloo, 4 envs a rank" in outs1[0]
    assert "multi-GPU: 2 ranks over gloo, 2 envs a rank" in outs2[0]
    assert "update 1/1:" in outs2[0] and "update 1/1:" not in outs2[1]
    final = []
    for name in ("cli1", "cli2"):
        root = runs["dir"] / name
        (run,) = os.listdir(root)
        for f in ("ckpt_final.pkl", "csv_final", "metrics.jsonl", "ckpt_1.pkl"):
            assert os.path.exists(root / run / f), (name, f)
        with open(root / run / "metrics.jsonl") as f:
            assert len(f.readlines()) == 1
        params, adam, step = tio.load_checkpoint(str(root / run / "ckpt_final.pkl"), "cpu")
        assert step == 1 and adam["count"] == 10
        final.append(tio.policy_params_to_numpy(params))
    for k, want in final[0].items():
        np.testing.assert_allclose(final[1][k], want, rtol=0, atol=RTOL * np.abs(want).max(),
                                   err_msg=k)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
