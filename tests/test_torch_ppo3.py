"""PyTorch port: the feed-forward policy (models/mlp.py) and the caller-driven
PPO (algo/ppo3.py) against the JAX package.

The MLP's forward and sequence, and ``ppo_loss`` with every gradient leaf
and 3 Adam steps under ``MlpPolicy``, on the same parameters from a numpy
seed; then ``PPO3`` of each policy driven by the same observations, rewards
and dones from numpy, with deterministic actions, from JAX's initial
parameters: the actions it returns, and the metrics and parameters after
``learn``. Small sizes on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo3 as tppo3
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import mlp as tmlp
from high_speed_quadrupedal_locomotion_by_irrl_tpu.algo import ppo as jppo
from high_speed_quadrupedal_locomotion_by_irrl_tpu.algo import ppo3 as jppo3
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import mlp as jmlp

torch.set_num_threads(1)

HIDDEN = (16, 16)
T, B = 6, 5
HEADS = ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")


def _jax_mlp(flat: dict) -> jmlp.MlpParams:
    """The port's {leaf name: array} dict as a JAX MlpParams."""
    def stack(tower):
        n = len({k.split(".")[1] for k in flat if k.startswith(tower + ".")})
        return tuple((jnp.asarray(flat[f"{tower}.{i}.w"]), jnp.asarray(flat[f"{tower}.{i}.b"]))
                     for i in range(n))
    return jmlp.MlpParams(pi_layers=stack("pi_layers"), v_layers=stack("v_layers"),
                          **{k: jnp.asarray(flat[k]) for k in HEADS})


def _flat_of_jax(p) -> dict:
    """A JAX parameter tree as the port's {leaf name: array} dict (the pytree
    order is the port's named_leaves order)."""
    pol = tmlp if isinstance(p, jmlp.MlpParams) else tlstm
    blank = pol.init(torch.Generator().manual_seed(0), 35, 12, HIDDEN, "cpu")
    leaves = [np.asarray(x) for x in jax.tree.leaves(p)]
    names = [k for k, _ in blank.named_leaves()]
    assert len(names) == len(leaves)
    return dict(zip(names, leaves))


def _mlp_params(seed: int, logstd: float = -0.5):
    rng = np.random.default_rng(seed)
    blank = tmlp.init(torch.Generator().manual_seed(0), n_hidden=HIDDEN, device="cpu")
    flat = {k: (0.3 * rng.normal(size=tuple(t.shape))).astype(np.float32)
            for k, t in blank.named_leaves()}
    flat["logstd"] = np.full(12, logstd, np.float32) + 0.1 * flat["logstd"]
    return tio.mlp_params_from_numpy(flat, device="cpu").requires_grad_(), _jax_mlp(flat)


def _batch(seed: int, jp):
    """Rollout-like data; the stored neglogpacs and values lie near what
    ``jp`` gives, so that both branches of each clip are taken."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    data = dict(obs=f(T, B, 35), actions=0.5 * f(T, B, 12), values=f(T, B),
                neglogpacs=f(T, B), returns=f(T, B),
                dones_before=(rng.random((T, B)) < 0.2).astype(np.float32),
                rewards=f(T, B), init_lstm_state=np.zeros((B, 0), np.float32))
    out = jmlp.forward(jp, jnp.asarray(data["obs"]), None, None)
    data["neglogpacs"] = np.asarray(jmlp.neglogp(out.mean, out.logstd,
                                                 jnp.asarray(data["actions"]))) + 0.2 * f(T, B)
    data["values"] = np.asarray(out.value) + 0.2 * f(T, B)
    return (tppo.Batch(**{k: torch.from_numpy(v) for k, v in data.items()}),
            jppo.Batch(**{k: jnp.asarray(v) for k, v in data.items()}))


def test_mlp_forward_and_sequence_match_jax():
    tp, jp = _mlp_params(1)
    obs = np.random.default_rng(2).normal(size=(T, B, 35)).astype(np.float32)
    state = torch.zeros(B, tmlp.state_size(HIDDEN))
    for got, want in ((tmlp.forward(tp, torch.from_numpy(obs[0]), state, torch.zeros(B)),
                       jmlp.forward(jp, obs[0], jnp.zeros((B, 0)), jnp.zeros(B))),
                      (tmlp.sequence(tp, torch.from_numpy(obs), torch.zeros(T, B), state),
                       jmlp.sequence(jp, obs, jnp.zeros((T, B)), jnp.zeros((B, 0))))):
        np.testing.assert_allclose(got.mean.detach().numpy(), np.asarray(want.mean), atol=1e-5)
        np.testing.assert_allclose(got.value.detach().numpy(), np.asarray(want.value), atol=1e-5)
        assert got.state.shape == (B, 0)
    act, _ = tmlp.deterministic_action(tp, torch.from_numpy(5.0 * obs[0]), state, torch.zeros(B))
    want, _ = jmlp.deterministic_action(jp, 5.0 * obs[0], jnp.zeros((B, 0)), jnp.zeros(B))
    np.testing.assert_allclose(act.detach().numpy(), np.asarray(want), atol=1e-5)
    assert act.abs().max() == 1.0
    # the JAX package's init structure and shapes, orthogonal columns
    fresh = tmlp.init(torch.Generator().manual_seed(3), n_hidden=HIDDEN, device="cpu")
    jfresh = jmlp.init(jax.random.PRNGKey(3), n_hidden=HIDDEN)
    assert [tuple(t.shape) for t in fresh.leaves()] == [x.shape for x in jax.tree.leaves(jfresh)]
    w = fresh.pi_layers[1][0]
    torch.testing.assert_close(w.T @ w, 2.0 * torch.eye(HIDDEN[1]), atol=1e-5, rtol=0)


def test_ppo_loss_gradients_and_three_adam_steps_under_mlp_match_jax():
    tp, jp = _mlp_params(4)
    tb, jb = _batch(5, jp)
    kw = dict(n_lstm=HIDDEN, policy="MlpPolicy", ent_coef=0.01, learning_rate=3e-3)
    tcfg, jcfg = tppo.PPOConfig(**kw), jppo.PPOConfig(**kw)
    (jl, jaux), jgrads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(jp, jb, jcfg)
    tl, taux = tppo.ppo_loss(tp, tb, tcfg)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-4)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    assert 0.0 < float(jaux["clipfrac"]) < 1.0, "one branch of the ratio clip went untested"
    want = _flat_of_jax(jgrads)
    for k, t in tp.named_leaves():
        np.testing.assert_allclose(t.grad.numpy(), want[k], atol=1e-5, rtol=1e-4, err_msg=k)
        assert np.abs(want[k]).max() > 0, k
    topt, jopt = tppo.make_optimizer(tcfg, tp), jppo.make_optimizer(jcfg)
    jst = jopt.init(jp)
    for _ in range(3):
        (jloss, _), grads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(jp, jb, jcfg)
        updates, jst = jopt.update(grads, jst, jp)
        jp = optax.apply_updates(jp, updates)
        metrics = tppo.train_minibatch(tp, topt, tb, tcfg)
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), atol=1e-5, rtol=1e-4)
    want = _flat_of_jax(jp)
    for k, v in tio.mlp_params_to_numpy(tp).items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("policy", ["CustomLSTMPolicy", "MlpPolicy"])
def test_ppo3_learn_matches_jax(policy):
    """PPO3 from JAX's initial parameters, driven with the same data and
    deterministic actions for T steps, then ``learn`` (10 full-batch epochs):
    actions, metrics and parameters within 1e-5."""
    # with deterministic actions logstd's surrogate gradient is the mean of the normalized
    # advantages, zero up to rounding, which Adam scales up to ~1e-5 a step; the entropy
    # bonus gives logstd a gradient that rounding does not decide
    cfg_kw = dict(n_lstm=HIDDEN, policy=policy, ent_coef=0.01)
    jagent = jppo3.PPO3(jppo.PPOConfig(**cfg_kw), n_envs=B, seed=7)
    tagent = tppo3.PPO3(tppo.PPOConfig(**cfg_kw), n_envs=B, seed=7, device="cpu")
    flat = _flat_of_jax(jagent.params)
    tagent.params = (tio.mlp_params_from_numpy(flat, "cpu") if policy == "MlpPolicy"
                     else tio.policy_params_from_numpy(flat, "cpu")).requires_grad_()
    tagent.optimizer = tppo.make_optimizer(tagent.cfg, tagent.params)
    rng = np.random.default_rng(8)
    obs = rng.normal(size=(B, 35)).astype(np.float32)
    for t in range(T):
        ja = jagent.get_next_action(obs, deterministic=True)
        ta = tagent.get_next_action(obs, deterministic=True)
        np.testing.assert_allclose(ta, ja, atol=1e-5, err_msg=f"step {t} action")
        obs = rng.normal(size=(B, 35)).astype(np.float32)
        rew = rng.normal(size=B).astype(np.float32)
        done = rng.random(B) < 0.25
        jagent.collect(obs, rew, done)
        tagent.collect(obs, rew, done)
    want, got = jagent.learn(obs), tagent.learn(obs)
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)
    assert want["avg_traj_len"] < T, "no episode ended: the bookkeeping went untested"
    expect = _flat_of_jax(jagent.params)
    for k, v in tio.policy_params_to_numpy(tagent.params).items():
        np.testing.assert_allclose(v, expect[k], atol=1e-5, err_msg=k)
    assert not tagent._buf and not tagent._rewards


def test_ppo3_samples_from_its_own_generator():
    """Stochastic actions: reproducible from the seed, clipped on return while
    the unclipped sample is stored."""
    runs = []
    for _ in range(2):
        agent = tppo3.PPO3(tppo.PPOConfig(n_lstm=HIDDEN), n_envs=B, seed=3, device="cpu")
        with torch.no_grad():
            agent.params.logstd.fill_(1.0)
        runs.append((agent.get_next_action(np.ones((B, 35), np.float32)), agent._buf[0][1]))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert np.abs(runs[0][0]).max() <= 1.0 < runs[0][1].abs().max()
    np.testing.assert_array_equal(runs[0][0], np.clip(runs[0][1].numpy(), -1.0, 1.0))
