"""Recurrent PPO on the device.

Port of ``algo/ppo.py`` (the reference's PPO2, ppo2.py:18-450). The rollout
is a Python loop over control steps carrying (env state, LSTM state, obs,
dones) and writing into preallocated (T, B, ...) buffers; GAE is a reverse
loop; the clipped surrogate + clipped value loss + entropy objective matches
ppo2.py:152-175 term for term; optimization is Adam(eps=1e-5) under
global-norm clipping (ppo2.py:190-197). Recurrent minibatching shuffles whole
environments, never steps, keeping sequences intact (ppo2.py:381-404), and all
environments are reset after every rollout (ppo2.py:577).

The env steps on the batch-in-lanes physics (``envs.blackpanther.step_batch``,
one fused kernel launch a control step) when ``env_cfg.use_lanes_physics``
is set, else on the per-env physics (``envs.blackpanther.step``), as the JAX
rollout chooses; ``cli/train.py`` sets the flag by the JAX package's rule.
The policy is any module of :mod:`..models.registry` (``ppo_cfg.policy``):
the recurrent LSTM or the feed-forward MLP.

Where the JAX package carries a PRNG key, :class:`TrainState` carries two
``torch.Generator``s on the device: one for the env, one for action noise and
minibatch permutations. On a terrain config the env state carries each env's
map offset and height scale through the rollout and its closing reset; a
``state_hook`` may rewrite the scale between updates (the z-scale
curriculum), and every update logs the scale its rollout ran at. Parameters
and the optimizer are updated in place. BPTT goes through
:func:`..models.lstm.sequence`: on the card the hand-written forward and
backward LSTM kernels, on the CPU the plain cells under autograd.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo.gae import advantages
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import registry


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; defaults = the reference's training run
    (run_bp_v5.py:227-242, ppo2.py:195-196)."""
    learning_rate: float = 1e-3
    lr_final: Optional[float] = None   # linear anneal target (None = constant)
    gamma: float = 0.99
    lam: float = 0.998
    clip_range: float = 0.2
    ent_coef: float = 0.0
    # Minimum policy entropy (nats, summed over action dims). After each
    # update the global logstd is projected UP (uniform additive bump) so
    # entropy(logstd) >= this floor (docs/evidence/terrain_leg2_r4.md).
    # None = off.
    entropy_floor: Optional[float] = None
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    noptepochs: int = 10
    nminibatches: int = 1
    n_steps: int = 750
    n_lstm: tuple = (48, 48)
    policy: str = "CustomLSTMPolicy"  # models.registry key (policy zoo parity)

    @property
    def policy_mod(self):
        return registry.get_policy(self.policy)


@dataclasses.dataclass
class TrainState:
    params: lstm.PolicyParams     # (or mlp.MlpParams) leaves require grad; updated in place
    opt_state: torch.optim.Adam   # the optimizer over params.leaves(); holds moments and lr
    env_state: bp.EnvState        # batched (B leading axis)
    lstm_state: torch.Tensor      # (B, S)
    obs: torch.Tensor             # (B, 35) normalized
    dones: torch.Tensor           # (B,) done flags after the last step
    gen_env: torch.Generator      # env randomness (resets, noise, commands)
    gen_train: torch.Generator    # action noise and minibatch permutations
    update_idx: int

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class Batch(NamedTuple):
    obs: torch.Tensor        # (T, B, 35)
    actions: torch.Tensor    # (T, B, 12)
    values: torch.Tensor     # (T, B)
    neglogpacs: torch.Tensor  # (T, B)
    returns: torch.Tensor    # (T, B)
    dones_before: torch.Tensor  # (T, B) mask for LSTM resets during BPTT
    rewards: torch.Tensor    # (T, B) true env rewards (for logging)
    init_lstm_state: torch.Tensor  # (B, S)


class EpStats(NamedTuple):
    """True per-episode bookkeeping (RaisimGymVecEnv.py:42-50 ``{"r","l"}``
    info dicts): returns/lengths of episodes that *terminated* during the
    rollout, exactly like the reference records them on ``done``. Episodes
    cut off by the end-of-rollout reset (ppo2.py:577) are not counted."""
    ret_sum: torch.Tensor   # () sum of completed-episode returns
    len_sum: torch.Tensor   # () sum of completed-episode lengths
    count: torch.Tensor     # () number of completed episodes


def make_optimizer(cfg: PPOConfig, params: lstm.PolicyParams) -> torch.optim.Adam:
    """Adam(eps=1e-5) over ``params.leaves()`` (ppo2.py:190-197 semantics);
    the global-norm clip is :func:`clip_by_global_norm_`, applied to the
    gradients before each step. The learning rate lives in the optimizer
    (``param_groups``), so the IRRL workflow's change of lr between imitation
    and relaxation, or a schedule, is a scalar write
    (:func:`with_learning_rate`)."""
    return torch.optim.Adam(params.leaves(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-5)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, as
    optax.clip_by_global_norm does (torch's clip_grad_norm_ divides by
    ``norm + 1e-6`` instead). Returns the norm before the clip."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)
    return norm


def scheduled_lr(cfg: PPOConfig, frac: float) -> float:
    """Learning rate at run fraction ``frac`` in [0, 1]: linear anneal from
    ``learning_rate`` to ``lr_final`` (constant when lr_final is None)."""
    if cfg.lr_final is None:
        return cfg.learning_rate
    f = min(max(frac, 0.0), 1.0)
    return cfg.learning_rate + (cfg.lr_final - cfg.learning_rate) * f


def with_learning_rate(opt_state: torch.optim.Adam, lr: float) -> torch.optim.Adam:
    """Set the optimizer's learning rate to ``lr`` (in place) and return it."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state


def init_train_state(env_cfg: EnvConfig, ppo_cfg: PPOConfig, seed: int,
                     params: Optional[lstm.PolicyParams] = None, device=None) -> TrainState:
    """``params``, if given, must live on ``device`` (default ``cuda``); its
    leaves are made trainable in place."""
    device = dev_mod.resolve(device)
    pol = ppo_cfg.policy_mod
    seeds = torch.randint(0, 2 ** 62, (3,), generator=torch.Generator().manual_seed(seed))
    g_params, gen_env, gen_train = (torch.Generator(device=device).manual_seed(int(s))
                                    for s in seeds)
    if params is None:
        params = pol.init(g_params, bp.OBS_DIM, bp.ACT_DIM, ppo_cfg.n_lstm, device)
    elif params.pi_w.device.type != device.type:
        raise ValueError(f"params live on {params.pi_w.device}, the train state on {device}")
    params.requires_grad_()
    env_state = bp.env_init(env_cfg, env_cfg.num_envs, gen_env, device)
    return TrainState(
        params=params, opt_state=make_optimizer(ppo_cfg, params), env_state=env_state,
        lstm_state=torch.zeros((env_cfg.num_envs, pol.state_size(ppo_cfg.n_lstm)),
                               device=device),
        obs=bp.observe(env_cfg, env_state),
        dones=torch.zeros(env_cfg.num_envs, dtype=torch.bool, device=device),
        gen_env=gen_env, gen_train=gen_train, update_idx=0)


def _clock(device: torch.device) -> float:
    """Host time once the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def rollout(env_cfg: EnvConfig, ppo_cfg: PPOConfig, ts: TrainState,
            timings: Optional[dict] = None):
    """Collect n_steps transitions; returns (new TrainState, Batch, EpStats).
    ``timings``, if given, receives the wall seconds of the collection loop
    (``rollout_s``) and of the bootstrap and GAE (``gae_s``), the device
    synchronized around each."""
    pol = ppo_cfg.policy_mod
    env_step = bp.step_batch if env_cfg.use_lanes_physics else bp.step
    T, B, dev = ppo_cfg.n_steps, env_cfg.num_envs, ts.obs.device
    t_start = _clock(dev) if timings is not None else 0.0
    buf = lambda *shape: torch.empty((T, B) + shape, device=dev)  # noqa: E731
    mb_obs, mb_actions = buf(bp.OBS_DIM), buf(bp.ACT_DIM)
    mb_values, mb_nlp, mb_dones_before, mb_rewards, mb_dones_after = (buf() for _ in range(5))
    env_state, lstm_state, obs, dones = ts.env_state, ts.lstm_state, ts.obs, ts.dones
    ep_ret, ep_len = torch.zeros(B, device=dev), torch.zeros(B, device=dev)
    ret_sum, len_sum = torch.zeros((), device=dev), torch.zeros((), device=dev)
    for t in range(T):
        dones_f = dones.to(obs.dtype)
        out = pol.forward(ts.params, obs, lstm_state, dones_f)
        action = lstm.sample(ts.gen_train, out.mean, out.logstd)
        mb_nlp[t] = lstm.neglogp(out.mean, out.logstd, action)
        # the unclipped action is stored; the env takes the action-space bounds
        # (Runner, ppo2.py:530)
        step_out = env_step(env_cfg, env_state, torch.clamp(action, -1.0, 1.0), ts.gen_env)
        mb_obs[t], mb_actions[t], mb_values[t] = obs, action, out.value
        mb_dones_before[t], mb_rewards[t], mb_dones_after[t] = dones_f, step_out.reward, step_out.done
        # per-episode accumulators; (r, l) counted on done like the reference's
        # episode info dicts (RaisimGymVecEnv.py:42-50)
        d = step_out.done
        ep_ret = ep_ret + step_out.reward
        ep_len = ep_len + 1.0
        ret_sum = ret_sum + torch.sum(torch.where(d, ep_ret, 0.0))
        len_sum = len_sum + torch.sum(torch.where(d, ep_len, 0.0))
        ep_ret = torch.where(d, 0.0, ep_ret)
        ep_len = torch.where(d, 0.0, ep_len)
        env_state, lstm_state, obs, dones = step_out.state, out.state, step_out.obs, d
    ep_stats = EpStats(ret_sum=ret_sum, len_sum=len_sum, count=torch.sum(mb_dones_after))
    t_collected = _clock(dev) if timings is not None else 0.0

    last_value = pol.forward(ts.params, obs, lstm_state, dones.to(obs.dtype)).value
    _, returns = advantages(mb_rewards, mb_values, mb_dones_after, last_value,
                            ppo_cfg.gamma, ppo_cfg.lam)
    batch = Batch(obs=mb_obs, actions=mb_actions, values=mb_values, neglogpacs=mb_nlp,
                  returns=returns, dones_before=mb_dones_before, rewards=mb_rewards,
                  init_lstm_state=ts.lstm_state)

    # reference resets every env after each rollout (ppo2.py:577); dones and the
    # LSTM state carry over
    env_state = bp.reset(env_cfg, env_state, ts.gen_env)
    new_ts = ts.replace(env_state=env_state, lstm_state=lstm_state,
                        obs=bp.observe(env_cfg, env_state), dones=dones)
    if timings is not None:
        timings["rollout_s"] = t_collected - t_start
        timings["gae_s"] = _clock(dev) - t_collected
    return new_ts, batch, ep_stats


def ppo_loss(params: lstm.PolicyParams, batch: Batch, ppo_cfg: PPOConfig):
    """Clipped-surrogate loss over full sequences (BPTT)."""
    seq = ppo_cfg.policy_mod.sequence(params, batch.obs, batch.dones_before,
                                      batch.init_lstm_state)
    nlp = lstm.neglogp(seq.mean, seq.logstd, batch.actions)          # (T,B)
    ent = torch.mean(lstm.entropy(seq.logstd))
    vpred = seq.value

    # population statistics (ddof = 0), as numpy and jax.numpy default to
    advs = batch.returns - batch.values
    advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)

    vpred_clipped = batch.values + torch.clamp(vpred - batch.values,
                                               -ppo_cfg.clip_range, ppo_cfg.clip_range)
    vf_loss = 0.5 * torch.mean(torch.maximum((vpred - batch.returns) ** 2,
                                             (vpred_clipped - batch.returns) ** 2))
    ratio = torch.exp(batch.neglogpacs - nlp)
    pg1 = -advs * ratio
    pg2 = -advs * torch.clamp(ratio, 1.0 - ppo_cfg.clip_range, 1.0 + ppo_cfg.clip_range)
    pg_loss = torch.mean(torch.maximum(pg1, pg2))
    loss = pg_loss - ent * ppo_cfg.ent_coef + vf_loss * ppo_cfg.vf_coef

    with torch.no_grad():
        approxkl = 0.5 * torch.mean((nlp - batch.neglogpacs) ** 2)
        clipfrac = torch.mean((torch.abs(ratio - 1.0) > ppo_cfg.clip_range).to(ratio.dtype))
    return loss, {"pg_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
                  "entropy": ent.detach(), "approxkl": approxkl, "clipfrac": clipfrac}


def _select_envs(batch: Batch, idx: torch.Tensor) -> Batch:
    """Take a subset of environments (recurrent minibatching shuffles envs)."""
    take_t = lambda x: torch.index_select(x, 1, idx)  # noqa: E731
    return Batch(
        obs=take_t(batch.obs), actions=take_t(batch.actions),
        values=take_t(batch.values), neglogpacs=take_t(batch.neglogpacs),
        returns=take_t(batch.returns), dones_before=take_t(batch.dones_before),
        rewards=take_t(batch.rewards),
        init_lstm_state=torch.index_select(batch.init_lstm_state, 0, idx))


def train_minibatch(params: lstm.PolicyParams, opt: torch.optim.Adam, mb: Batch,
                    ppo_cfg: PPOConfig) -> dict:
    """One optimizer step on one minibatch: loss, gradients (BPTT), the
    global-norm clip, Adam. Returns the step's metrics as 0-d tensors, the
    gradient's global norm before the clip among them."""
    loss, aux = ppo_loss(params, mb, ppo_cfg)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = clip_by_global_norm_([p.grad for p in params.leaves()], ppo_cfg.max_grad_norm)
    opt.step()
    return {"loss": loss.detach(), **aux, "grad_norm": grad_norm}


def _mean_metrics(rows: list) -> dict:
    return {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}


def make_update_fn(env_cfg: EnvConfig, ppo_cfg: PPOConfig) -> Callable:
    """One full PPO update: rollout + noptepochs x env-shuffled minibatches.

    Returns a function TrainState -> (TrainState, metrics dict of 0-d tensors
    and floats). Beside the JAX package's metrics it reports the mean loss of
    the first and of the last epoch (``loss_first_epoch``,
    ``loss_last_epoch``), the wall seconds of the update's three parts
    (``time_rollout_s``, ``time_gae_s``, ``time_epochs_s``) and, on a terrain
    config, the mean terrain height scale of its rollout
    (``terrain_z_scale``).
    """
    n_envs = env_cfg.num_envs
    nmb = ppo_cfg.nminibatches
    if n_envs % nmb:
        raise ValueError("num_envs must be divisible by nminibatches")

    def update(ts: TrainState):
        timings: dict = {}
        z_scale = ts.env_state.terrain.z_scale.mean() if env_cfg.terrain else None
        ts, batch, ep = rollout(env_cfg, ppo_cfg, ts, timings)
        dev = batch.obs.device
        t0 = _clock(dev)
        epochs = []
        for _ in range(ppo_cfg.noptepochs):
            perm = torch.randperm(n_envs, generator=ts.gen_train, device=dev).reshape(nmb, -1)
            epochs.append(_mean_metrics([
                train_minibatch(ts.params, ts.opt_state, _select_envs(batch, idx), ppo_cfg)
                for idx in perm]))
        metrics = _mean_metrics(epochs)   # entropy: as logged before the projection below
        metrics["loss_first_epoch"] = epochs[0]["loss"]
        metrics["loss_last_epoch"] = epochs[-1]["loss"]
        with torch.no_grad():
            if ppo_cfg.entropy_floor is not None:
                # project entropy back to the floor: uniform additive logstd
                # bump (entropy is sum(logstd) + const, so this is the
                # minimum-norm projection onto {entropy >= floor})
                logstd = ts.params.logstd
                bump = (torch.clamp(ppo_cfg.entropy_floor - lstm.entropy(logstd), min=0.0)
                        / logstd.shape[-1])
                logstd.add_(bump)
            # explained variance (logger parity, ppo2.py:424-435)
            var_y = torch.var(batch.returns, correction=0)
            metrics["explained_variance"] = 1.0 - torch.var(
                batch.returns - batch.values, correction=0) / (var_y + 1e-8)
            # true episode bookkeeping: mean return/length over episodes that
            # terminated this rollout (= the reference's safe_mean over ep_info_buf,
            # ppo2.py:424-428); NaN-free when nothing terminated
            count = torch.clamp(ep.count, min=1.0)
            metrics["ep_rew_mean"] = ep.ret_sum / count
            metrics["ep_len_mean"] = ep.len_sum / count
            metrics["ep_count"] = ep.count
            metrics["reward_per_step"] = torch.mean(batch.rewards)
        if z_scale is not None:
            metrics["terrain_z_scale"] = z_scale
        metrics["time_rollout_s"] = timings["rollout_s"]
        metrics["time_gae_s"] = timings["gae_s"]
        metrics["time_epochs_s"] = _clock(dev) - t0
        ts.update_idx += 1
        return ts, metrics

    return update


def learn(env_cfg: EnvConfig, ppo_cfg: PPOConfig, total_timesteps: int,
          seed: int, params: Optional[lstm.PolicyParams] = None,
          eval_every_n: int = 100, callback=None, verbose: bool = True,
          metrics_hook=None, opt_state: Optional[dict] = None, state_hook=None,
          device=None) -> TrainState:
    """Training loop (PPO2.learn parity: periodic eval hook + checkpointing
    are the caller's callback, mirroring ppo2.py:331-341; ``metrics_hook``
    fires every update: the CLI uses it to persist metrics.jsonl).
    ``opt_state`` restores Adam from a checkpoint's plain dict
    (``models.io.load_checkpoint``), its learning rate included, as the JAX
    package's resume does; env/LSTM states re-init fresh, which is
    sound for on-policy PPO. ``state_hook(ts, frac) -> ts`` runs before each
    update with the run fraction in [0, 1]."""
    ts = init_train_state(env_cfg, ppo_cfg, seed, params, device)
    if opt_state is not None and not mio.adam_state_from_numpy(ts.opt_state, ts.params,
                                                               opt_state):
        print("resume: checkpoint optimizer state has a different "
              "structure (other parameter shapes); starting Adam fresh")
    update_fn = make_update_fn(env_cfg, ppo_cfg)
    batch_size = env_cfg.num_envs * ppo_cfg.n_steps
    n_updates = max(1, total_timesteps // batch_size)
    try:
        for i in range(n_updates):
            t0 = time.time()
            if state_hook is not None:
                ts = state_hook(ts, i / max(n_updates - 1, 1))
            if ppo_cfg.lr_final is not None:
                lr_i = scheduled_lr(ppo_cfg, i / max(n_updates - 1, 1))
                with_learning_rate(ts.opt_state, lr_i)
            ts, metrics = update_fn(ts)
            if verbose or callback or metrics_hook:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["fps"] = batch_size / max(time.time() - t0, 1e-9)
                metrics["timesteps"] = (i + 1) * batch_size
                if ppo_cfg.lr_final is not None:
                    metrics["lr"] = lr_i
            if verbose:
                print(f"update {i + 1}/{n_updates}: " +
                      " ".join(f"{k}={v:.4g}" for k, v in metrics.items()))
            if metrics_hook is not None:
                metrics_hook(metrics)
            if callback is not None and (i % eval_every_n == 0
                                         or i == n_updates - 1):
                callback(ts, metrics)
    except KeyboardInterrupt:
        # PPO2 parity (ppo2.py:443-448): a Ctrl-C returns the live train
        # state so the caller's final save still runs: a long run is
        # never lost to an interrupt.
        print(f"learn: interrupted at update {ts.update_idx}; "
              "returning current state for the final save")
    return ts
