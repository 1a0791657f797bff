"""PyTorch port: recurrent PPO (algo/gae, algo/ppo, models/io) against the JAX package.

Everything runs on the CPU at a small size (2 x LSTM(16) a tower, T <= 8,
B <= 6). Inputs come from numpy with a seed and go through the JAX function
and its counterpart in the port; on the CPU the port's LSTM layers are the
plain cells under autograd. The JAX PRNG cannot be reproduced in torch, so
the rollout is checked by feeding what it stored back through the JAX
package's sequence, distribution ops and GAE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import gae as tgae
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo as tppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import mlp as tmlp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import registry as tregistry
from high_speed_quadrupedal_locomotion_by_irrl_tpu.algo import gae as jgae
from high_speed_quadrupedal_locomotion_by_irrl_tpu.algo import ppo as jppo
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm

torch.set_num_threads(1)

N_LSTM = (16, 16)
T, B = 8, 6
LEAF_KEYS = ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")


def jax_params(flat: dict) -> jlstm.PolicyParams:
    """The port's {leaf name: array} dict as a JAX PolicyParams."""
    def stack(tower):
        n = len({k.split(".")[1] for k in flat if k.startswith(tower + ".")})
        return tuple(jlstm.LSTMWeights(*(jnp.asarray(flat[f"{tower}.{i}.{k}"])
                                         for k in ("wx", "wh", "b"))) for i in range(n))
    return jlstm.PolicyParams(pi_lstm=stack("pi_lstm"), v_lstm=stack("v_lstm"),
                              **{k: jnp.asarray(flat[k]) for k in LEAF_KEYS})


def flat_of_jax(p: jlstm.PolicyParams) -> dict:
    """A JAX PolicyParams-shaped tree as the port's {leaf name: array} dict."""
    out = {f"{tower}.{i}.{k}": np.asarray(getattr(w, k))
           for tower in ("pi_lstm", "v_lstm") for i, w in enumerate(getattr(p, tower))
           for k in ("wx", "wh", "b")}
    out.update({k: np.asarray(getattr(p, k)) for k in LEAF_KEYS})
    return out


def make_params(seed: int, logstd: float = -0.5):
    """The same random parameters in both packages, from a numpy seed."""
    rng = np.random.default_rng(seed)
    blank = tlstm.init(torch.Generator().manual_seed(0), n_lstm=N_LSTM, device="cpu")
    flat = {k: (0.3 * rng.normal(size=tuple(t.shape))).astype(np.float32)
            for k, t in blank.named_leaves()}
    flat["logstd"] = np.full(12, logstd, np.float32) + 0.1 * flat["logstd"]
    return tio.policy_params_from_numpy(flat, device="cpu").requires_grad_(), jax_params(flat)


def make_batch(seed: int, jp=None):
    """One batch of rollout-like data from numpy, for both packages. With
    ``jp`` the stored neglogpacs and values lie near what those parameters
    give (as after a rollout), so that both branches of each clip are taken."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    data = dict(obs=f(T, B, 35), actions=0.5 * f(T, B, 12), values=f(T, B),
                neglogpacs=5.0 + f(T, B), returns=f(T, B),
                dones_before=(rng.random((T, B)) < 0.2).astype(np.float32),
                rewards=f(T, B), init_lstm_state=0.5 * f(B, 4 * sum(N_LSTM)))
    assert 0 < data["dones_before"][1:].sum()
    if jp is not None:
        seq = jlstm.sequence(jp, *(jnp.asarray(data[k])
                                   for k in ("obs", "dones_before", "init_lstm_state")))
        nlp = jlstm.neglogp(seq.mean, seq.logstd, jnp.asarray(data["actions"]))
        data["neglogpacs"] = np.asarray(nlp) + 0.2 * f(T, B)
        data["values"] = np.asarray(seq.value) + 0.2 * f(T, B)
    return (tppo.Batch(**{k: torch.from_numpy(v) for k, v in data.items()}),
            jppo.Batch(**{k: jnp.asarray(v) for k, v in data.items()}))


def assert_leaves_close(got: dict, want: dict, atol: float, rtol: float = 0.0):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    r, v = (rng.normal(size=(16, B)).astype(np.float32) for _ in range(2))
    d = rng.random((16, B)) < 0.15
    last = rng.normal(size=B).astype(np.float32)
    want = jgae.advantages(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(last),
                           0.99, 0.998)
    got = tgae.advantages(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(d),
                          torch.from_numpy(last), 0.99, 0.998)
    for g, w in zip(got, want):   # a 16-step f32 recursion, fused otherwise
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_ppo_loss_and_every_gradient_leaf_match_jax():
    tp, jp = make_params(1)
    tb, jb = make_batch(2, jp)
    tcfg = tppo.PPOConfig(n_lstm=N_LSTM, ent_coef=0.01)
    jcfg = jppo.PPOConfig(n_lstm=N_LSTM, ent_coef=0.01)
    (jl, jaux), jgrads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(jp, jb, jcfg)
    tl, taux = tppo.ppo_loss(tp, tb, tcfg)
    tl.backward()
    # f32 sums over T*B = 48 samples and an 8-step recurrence, taken in another order
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-4)
    assert taux.keys() == jaux.keys()
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    assert 0.0 < float(jaux["clipfrac"]) < 1.0, "one branch of the ratio clip went untested"
    vdiff = np.abs(np.asarray(jlstm.sequence(jp, jb.obs, jb.dones_before, jb.init_lstm_state).value
                              - jb.values))
    assert (vdiff > 0.2).any() and (vdiff < 0.2).any(), "one branch of the value clip went untested"
    got = {k: t.grad.numpy() for k, t in tp.named_leaves()}
    assert_leaves_close(got, flat_of_jax(jgrads), atol=1e-5, rtol=1e-4)
    assert all(np.abs(g).max() > 0 for g in got.values())


def _optax_with_adam_state(jcfg, jp, mu, nu, count):
    """The JAX package's optimizer state with Adam's moments and count set."""
    st = jppo.make_optimizer(jcfg).init(jp)
    clip_state, (adam, *rest) = st.inner_state
    adam = adam._replace(count=jnp.asarray(count, jnp.int32), mu=jax_params(mu),
                         nu=jax_params(nu))
    return st._replace(inner_state=(clip_state, (adam, *rest)))


@pytest.mark.parametrize("max_grad_norm,clipped", [(0.05, True), (100.0, False)])
def test_three_epochs_on_a_fixed_batch_match_optax(max_grad_norm, clipped):
    """3 epochs of one-minibatch updates from one Adam state (moments and
    count set, not fresh) in both packages: parameters, Adam's moments and the
    losses agree, with the gradient norm once above and once below the clip.
    One minibatch holds every env, so no permutation enters."""
    tp, jp = make_params(3)
    tb, jb = make_batch(4, jp)
    kw = dict(n_lstm=N_LSTM, max_grad_norm=max_grad_norm, learning_rate=3e-3)
    tcfg, jcfg = tppo.PPOConfig(**kw), jppo.PPOConfig(**kw)
    rng = np.random.default_rng(5)
    names = [k for k, _ in tp.named_leaves()]
    shapes = {k: tuple(t.shape) for k, t in tp.named_leaves()}
    mu = {k: (0.01 * rng.normal(size=shapes[k])).astype(np.float32) for k in names}
    nu = {k: (1e-4 * rng.random(size=shapes[k])).astype(np.float32) for k in names}

    topt = tppo.make_optimizer(tcfg, tp)
    assert tio.adam_state_from_numpy(topt, tp, {"mu": mu, "nu": nu, "count": 7})
    jopt, jst = jppo.make_optimizer(jcfg), _optax_with_adam_state(jcfg, jp, mu, nu, 7)

    @jax.jit
    def jstep(params, st):
        (loss, _), grads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(params, jb, jcfg)
        updates, st = jopt.update(grads, st, params)
        return optax.apply_updates(params, updates), st, loss, optax.global_norm(grads)

    for _ in range(3):
        jp, jst, jloss, jnorm = jstep(jp, jst)
        assert (float(jnorm) > max_grad_norm) == clipped
        metrics = tppo.train_minibatch(tp, topt, tb, tcfg)
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), atol=1e-5, rtol=1e-4)
    # three Adam steps of lr 3e-3 on gradients that agree to 1e-5 + 1e-4 rel
    assert_leaves_close(tio.policy_params_to_numpy(tp), flat_of_jax(jp), atol=1e-5)
    adam = tio.adam_state_to_numpy(topt, tp)
    jadam = jst.inner_state[1][0]
    assert adam["count"] == int(jadam.count) == 10
    assert_leaves_close(adam["mu"], flat_of_jax(jadam.mu), atol=1e-6, rtol=1e-4)
    assert_leaves_close(adam["nu"], flat_of_jax(jadam.nu), atol=1e-8, rtol=1e-3)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(6)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((5, 7), (3,), (2, 2))]
    for max_norm in (0.5, 1e3):   # above and below the norm of ~7
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                            optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = tppo.clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in grads)),
                                   rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_scheduled_lr_and_with_learning_rate():
    kw = dict(learning_rate=1e-3, lr_final=2e-4)
    for frac in (-0.5, 0.0, 0.3, 1.0, 2.0):
        assert tppo.scheduled_lr(tppo.PPOConfig(**kw), frac) == pytest.approx(
            jppo.scheduled_lr(jppo.PPOConfig(**kw), frac), rel=1e-12)
    assert tppo.scheduled_lr(tppo.PPOConfig(learning_rate=5e-4), 0.7) == 5e-4
    tp, _ = make_params(0)
    opt = tppo.make_optimizer(tppo.PPOConfig(learning_rate=1e-3), tp)
    assert opt.param_groups[0]["lr"] == 1e-3 and opt.defaults["eps"] == 1e-5
    assert tppo.with_learning_rate(opt, 5e-4) is opt
    assert all(g["lr"] == 5e-4 for g in opt.param_groups)
    # the lr is read at the step: one step from zero moments moves each weight by ~lr
    tp.pi_b.grad = torch.ones_like(tp.pi_b)
    for p in tp.leaves():
        p.grad = torch.ones_like(p) if p.grad is None else p.grad
    before = tp.pi_b.detach().clone()
    opt.step()
    np.testing.assert_allclose((before - tp.pi_b.detach()).numpy(), 5e-4, rtol=1e-3)


@pytest.mark.parametrize("floor", [None, -20.0, 12.0])
def test_entropy_floor_projection_matches_jax(floor, monkeypatch):
    """The projection after the epochs (ppo.py:291-298), isolated by an update
    whose rollout is a fixed batch and whose epochs are none: logstd is bumped
    up uniformly to the floor, or left alone below it; the logged entropy is
    the one from before the projection."""
    tp, jp = make_params(7, logstd=-1.0)
    tb, _ = make_batch(8)
    cfg = tppo.PPOConfig(n_lstm=N_LSTM, entropy_floor=floor, noptepochs=1, learning_rate=0.0)
    ent_before = float(jlstm.entropy(jp.logstd))
    assert -20.0 < ent_before < 12.0
    # the JAX package's projection, spelled as in make_update_fn
    want = np.asarray(jp.logstd)
    if floor is not None:
        want = want + np.maximum(floor - ent_before, 0.0) / want.shape[-1]
    ts = tppo.TrainState(params=tp, opt_state=tppo.make_optimizer(cfg, tp), env_state=None,
                         lstm_state=None, obs=None, dones=None, gen_env=None,
                         gen_train=torch.Generator().manual_seed(0), update_idx=0)
    ep = tppo.EpStats(torch.tensor(3.0), torch.tensor(10.0), torch.tensor(2.0))
    monkeypatch.setattr(tppo, "rollout", lambda env_cfg, ppo_cfg, ts, timings=None: (
        timings.update(rollout_s=0.0, gae_s=0.0) or (ts, tb, ep)))
    ts, metrics = tppo.make_update_fn(tconfig.train_default().replace(num_envs=B), cfg)(ts)
    np.testing.assert_allclose(tp.logstd.detach().numpy(), want, atol=1e-6)
    np.testing.assert_allclose(float(tlstm.entropy(tp.logstd.detach())),
                               ent_before if floor is None else max(ent_before, floor), atol=1e-5)
    np.testing.assert_allclose(metrics["entropy"].item(), ent_before, atol=1e-5)
    assert ts.update_idx == 1
    assert metrics["ep_rew_mean"].item() == 1.5 and metrics["ep_len_mean"].item() == 5.0
    # explained variance and reward_per_step as ppo.py:300-309, population variance
    ret, val = tb.returns.numpy(), tb.values.numpy()
    np.testing.assert_allclose(metrics["explained_variance"].item(),
                               1.0 - np.var(ret - val) / (np.var(ret) + 1e-8), rtol=1e-5)
    np.testing.assert_allclose(metrics["reward_per_step"].item(), tb.rewards.numpy().mean(),
                               atol=1e-7)


def test_select_envs_keeps_whole_envs():
    tb, jb = make_batch(9)
    idx = np.array([4, 1, 5])
    got = tppo._select_envs(tb, torch.from_numpy(idx))
    want = jppo._select_envs(jb, jnp.asarray(idx))
    for name in tppo.Batch._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w, err_msg=name)
    # every step of env 4 and its initial state, in order
    np.testing.assert_array_equal(got.obs[:, 0].numpy(), tb.obs[:, 4].numpy())
    np.testing.assert_array_equal(got.init_lstm_state[0].numpy(), tb.init_lstm_state[4].numpy())


def test_update_shuffles_whole_envs_into_minibatches(monkeypatch):
    """nminibatches = 3 over 6 envs: every epoch trains on each env once, two
    envs a minibatch, all steps of an env together."""
    tp, _ = make_params(10)
    tb, _ = make_batch(11)
    tb = tb._replace(values=torch.arange(B, dtype=torch.float32).expand(T, B).contiguous())
    cfg = tppo.PPOConfig(n_lstm=N_LSTM, nminibatches=3, noptepochs=2)
    seen = []
    monkeypatch.setattr(tppo, "rollout", lambda env_cfg, ppo_cfg, ts, timings=None: (
        timings.update(rollout_s=0.0, gae_s=0.0) or
        (ts, tb, tppo.EpStats(*(torch.zeros(()) for _ in range(3))))))
    real = tppo.train_minibatch
    monkeypatch.setattr(tppo, "train_minibatch",
                        lambda p, o, mb, c: seen.append(mb.values.numpy().copy()) or real(p, o, mb, c))
    ts = tppo.TrainState(params=tp, opt_state=tppo.make_optimizer(cfg, tp), env_state=None,
                         lstm_state=None, obs=None, dones=None, gen_env=None,
                         gen_train=torch.Generator().manual_seed(3), update_idx=0)
    tppo.make_update_fn(tconfig.train_default().replace(num_envs=B), cfg)(ts)
    assert len(seen) == 6 and all(v.shape == (T, 2) for v in seen)
    for epoch in (seen[:3], seen[3:]):
        assert all((v == v[0]).all() for v in epoch)   # a column is one env at every step
        assert sorted(int(e) for v in epoch for e in v[0]) == list(range(B))


def test_rollout_is_reproduced_by_the_jax_package(monkeypatch):
    """What the port's rollout stored (obs, dones, unclipped actions) goes
    through the JAX package's sequence, neglogp and GAE: they reproduce the
    stored values, neglogpacs and returns, and the JAX forward reproduces the
    bootstrap value. Episode statistics against a numpy count. Observation
    noise is raised so that episodes end inside 8 steps. The env steps on the
    lanes physics (the per-env path: tests/test_torch_perenv.py)."""
    env_cfg = tconfig.train_default().replace(num_envs=B, obs_noise=20.0, use_lanes_physics=True)
    cfg = tppo.PPOConfig(n_lstm=N_LSTM, n_steps=T)
    tp, jp = make_params(12, logstd=-2.0)
    ts0 = tppo.init_train_state(env_cfg, cfg, seed=3, params=tp, device="cpu")
    start_state = torch.randn(B, 4 * sum(N_LSTM), generator=torch.Generator().manual_seed(1))
    ts0 = ts0.replace(lstm_state=start_state)
    n = lambda t: t.detach().numpy().astype(np.float32)  # noqa: E731
    forwards, gae_args, env_actions = [], [], []
    real_forward, real_gae, real_step = tlstm.forward, tppo.advantages, tppo.bp.step_batch
    monkeypatch.setattr(tlstm, "forward", lambda p, o, s, d, **kw: (
        forwards.append((n(o), n(s), n(d))) or real_forward(p, o, s, d, **kw)))
    monkeypatch.setattr(tppo, "advantages", lambda *a: gae_args.append(a) or real_gae(*a))
    monkeypatch.setattr(tppo.bp, "step_batch", lambda c, st, a, g: (
        env_actions.append(n(a)) or real_step(c, st, a, g)))
    ts, batch, ep = tppo.rollout(env_cfg, cfg, ts0)

    assert batch.obs.shape == (T, B, 35) and batch.actions.shape == (T, B, 12)
    np.testing.assert_array_equal(n(batch.init_lstm_state), n(start_state))
    np.testing.assert_array_equal(n(batch.obs[0]), n(ts0.obs))
    assert not n(batch.dones_before[0]).any()
    # the stored action is the sample; the env took it clipped to the action bounds
    assert len(forwards) == T + 1 and len(env_actions) == T
    np.testing.assert_array_equal(np.stack(env_actions), np.clip(n(batch.actions), -1.0, 1.0))

    seq = jlstm.sequence(jp, jnp.asarray(n(batch.obs)), jnp.asarray(n(batch.dones_before)),
                         jnp.asarray(n(start_state)))
    # an 8-step f32 recurrence, products summed in another order
    np.testing.assert_allclose(n(batch.values), np.asarray(seq.value), atol=1e-5)
    np.testing.assert_allclose(
        n(batch.neglogpacs),
        np.asarray(jlstm.neglogp(seq.mean, seq.logstd, jnp.asarray(n(batch.actions)))),
        atol=1e-4, rtol=1e-5)   # z^2 / 2 with exp(-logstd) = 7.4: 1e-5 on the mean becomes 1e-4
    np.testing.assert_allclose(n(ts.lstm_state), np.asarray(seq.state), atol=1e-5)

    rewards, values, dones_after, last_value = (n(a) for a in gae_args[0][:4])
    np.testing.assert_array_equal(rewards, n(batch.rewards))
    np.testing.assert_array_equal(values, n(batch.values))
    np.testing.assert_array_equal(dones_after[:-1], n(batch.dones_before)[1:])
    np.testing.assert_array_equal(dones_after[-1], n(ts.dones))
    assert dones_after.sum() > 0, "no episode ended: the bookkeeping went untested"
    boot = jlstm.forward(jp, *(jnp.asarray(a) for a in forwards[-1]))
    np.testing.assert_allclose(last_value, np.asarray(boot.value), atol=1e-5)
    _, want_returns = jgae.advantages(jnp.asarray(rewards), jnp.asarray(values),
                                      jnp.asarray(dones_after), jnp.asarray(last_value),
                                      cfg.gamma, cfg.lam)
    np.testing.assert_allclose(n(batch.returns), np.asarray(want_returns), atol=1e-5)

    ret_sum = len_sum = 0.0
    for b in range(B):
        acc_r, acc_l = 0.0, 0
        for t in range(T):
            acc_r, acc_l = acc_r + rewards[t, b], acc_l + 1
            if dones_after[t, b]:
                ret_sum, len_sum = ret_sum + acc_r, len_sum + acc_l
                acc_r, acc_l = 0.0, 0
    np.testing.assert_allclose(ep.ret_sum.item(), ret_sum, atol=1e-5)
    assert ep.len_sum.item() == len_sum and ep.count.item() == dones_after.sum()
    # every env was reset after the rollout; dones and the LSTM state carry over
    assert (n(ts.env_state.ep_len) == 0).all() and (n(ts.env_state.frame_idx) == 1).all()
    np.testing.assert_array_equal(n(ts.obs), n(tppo.bp.observe(env_cfg, ts.env_state)))


def test_csv_export_goes_both_ways(tmp_path):
    tp, jp = make_params(13)
    tio.save_bp5_csv(tp, str(tmp_path / "from_torch"))
    jio.save_bp5_csv(jp, str(tmp_path / "from_jax"))
    rounded = {k: np.round(v.astype(np.float64), 6).astype(np.float32)
               for k, v in tio.policy_params_to_numpy(tp).items()}
    into_jax = flat_of_jax(jio.load_bp5_csv(str(tmp_path / "from_torch"), n_lstm=N_LSTM))
    into_torch = tio.policy_params_to_numpy(
        tio.load_bp5_csv(str(tmp_path / "from_jax"), n_lstm=N_LSTM, device="cpu"))
    for got in (into_jax, into_torch):   # %.6f: half a unit of the sixth decimal
        assert_leaves_close(got, tio.policy_params_to_numpy(tp), atol=5.1e-7)
        assert_leaves_close(got, rounded, atol=1e-7)
    assert into_jax["vf_w"].shape == (16, 1) and into_torch["logstd"].shape == (12,)
    assert sorted(p.name for p in (tmp_path / "from_torch").iterdir()) == sorted(
        p.name for p in (tmp_path / "from_jax").iterdir())


def test_checkpoint_round_trip_with_adam_state(tmp_path):
    tp, _ = make_params(14)
    tb, _ = make_batch(15)
    cfg = tppo.PPOConfig(n_lstm=N_LSTM, learning_rate=7e-4)
    opt = tppo.make_optimizer(cfg, tp)
    for _ in range(2):
        tppo.train_minibatch(tp, opt, tb, cfg)
    path = str(tmp_path / "sub" / "ckpt.pkl")
    tio.save_checkpoint(path, tp, opt, step=2)
    p2, adam, step = tio.load_checkpoint(path, device="cpu")
    assert step == 2 and adam["count"] == 2 and adam["lr"] == 7e-4
    assert_leaves_close(tio.policy_params_to_numpy(p2), tio.policy_params_to_numpy(tp), atol=0)
    p2.requires_grad_()
    opt2 = tppo.make_optimizer(tppo.PPOConfig(n_lstm=N_LSTM, learning_rate=1e-3), p2)
    assert tio.adam_state_from_numpy(opt2, p2, adam)
    assert opt2.param_groups[0]["lr"] == 7e-4
    # both continue identically: the moments, the count and the lr came back
    tppo.train_minibatch(tp, opt, tb, cfg)
    tppo.train_minibatch(p2, opt2, tb, cfg)
    assert_leaves_close(tio.policy_params_to_numpy(p2), tio.policy_params_to_numpy(tp), atol=0)
    # a state of other shapes is refused and leaves the optimizer fresh
    other = tlstm.init(torch.Generator().manual_seed(0), n_lstm=(8, 8), device="cpu").requires_grad_()
    opt3 = tppo.make_optimizer(cfg, other)
    assert not tio.adam_state_from_numpy(opt3, other, adam) and not opt3.state
    # the blob holds only dicts, numbers and numpy arrays
    import pickle
    with open(path, "rb") as f:
        blob = pickle.load(f)
    # the terrain height scale is recorded for runs on terrain, None here
    assert set(blob) == {"step", "params", "adam", "terrain_z_scale"}
    assert blob["terrain_z_scale"] is None
    assert all(isinstance(v, np.ndarray) for v in blob["params"].values())


def test_checkpoints_of_the_jax_package_are_refused(tmp_path):
    _, jp = make_params(16)
    path = str(tmp_path / "jax.pkl")
    jio.save_checkpoint(path, (jp, None), 3)
    with pytest.raises(ValueError, match="bp5 CSV directory"):
        tio.load_checkpoint(path, device="cpu")


def test_registry_names():
    assert tregistry.get_policy("CustomLSTMPolicy") is tlstm
    assert tregistry.get_policy("LstmPolicy") is tlstm
    assert tppo.PPOConfig().policy_mod is tlstm
    assert tregistry.get_policy("MlpPolicy") is tmlp
    assert tppo.PPOConfig(policy="MlpPolicy").policy_mod is tmlp
    with pytest.raises(KeyError, match="unknown policy"):
        tregistry.get_policy("nope")
    with pytest.raises(ValueError, match="already registered"):
        tregistry.register_policy("LstmPolicy", tio)
