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

With a ``mesh`` (:mod:`..parallel.mesh`, ``cli/train.py --distributed``)
each rank rolls out its block of the envs, drawing through the rank-block
generators that :func:`..parallel.train.shard_train_state` gives it, and the
JAX package's implicit ``psum``s are written out: every epoch draws the
global permutation, each rank trains on the members of each minibatch it
owns (possibly none) with local sums over the minibatch's global counts, and
one all-reduce a minibatch sums the gradients and the loss terms, so the
clip and Adam are the same on every rank. The update's metrics come from
global sums and counts.
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
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import mesh as pmesh
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling


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
    gen_env: torch.Generator      # env randomness (resets, noise, commands); a RankBlock when sharded
    gen_train: torch.Generator    # action noise and minibatch permutations; likewise
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
    T, B, dev = ppo_cfg.n_steps, ts.obs.shape[0], ts.obs.device
    with profiling.span("ppo.rollout"):
        t_start = _clock(dev) if timings is not None else 0.0
        buf = lambda *shape: torch.empty((T, B) + shape, device=dev)  # noqa: E731
        mb_obs, mb_actions = buf(bp.OBS_DIM), buf(bp.ACT_DIM)
        mb_values, mb_nlp, mb_dones_before, mb_rewards, mb_dones_after = (buf() for _ in range(5))
        env_state, lstm_state, obs, dones = ts.env_state, ts.lstm_state, ts.obs, ts.dones
        ep_ret, ep_len = torch.zeros(B, device=dev), torch.zeros(B, device=dev)
        ret_sum, len_sum = torch.zeros((), device=dev), torch.zeros((), device=dev)
        for t in range(T):
            profiling.set_step(t)
            with profiling.span("ppo.policy"):
                dones_f = dones.to(obs.dtype)
                # heads by row_product: a row acts alike whatever the width (and world size)
                out = pol.forward(ts.params, obs, lstm_state, dones_f, stable_rows=True)
                action = lstm.sample(ts.gen_train, out.mean, out.logstd)
                mb_nlp[t] = lstm.neglogp(out.mean, out.logstd, action)
                # the unclipped action is stored; the env takes the action-space bounds
                # (Runner, ppo2.py:530)
                env_action = torch.clamp(action, -1.0, 1.0)
            step_out = env_step(env_cfg, env_state, env_action, ts.gen_env)
            with profiling.span("ppo.record"):
                mb_obs[t], mb_actions[t], mb_values[t] = obs, action, out.value
                mb_dones_before[t], mb_rewards[t] = dones_f, step_out.reward
                mb_dones_after[t] = step_out.done
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
        profiling.set_step(None)
        ep_stats = EpStats(ret_sum=ret_sum, len_sum=len_sum, count=torch.sum(mb_dones_after))
        t_collected = _clock(dev) if timings is not None else 0.0

    with profiling.span("ppo.gae"):
        last_value = pol.forward(ts.params, obs, lstm_state, dones.to(obs.dtype),
                                 stable_rows=True).value
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


class Shard(NamedTuple):
    """A rank's part of a minibatch spread over ranks: the minibatch's
    global count of (step, env) samples, its advantages' global mean and
    population std, and the rank's share of its envs."""
    n: int
    adv_mean: torch.Tensor
    adv_std: torch.Tensor
    share: float


def ppo_loss(params: lstm.PolicyParams, batch: Batch, ppo_cfg: PPOConfig,
             shard: Optional[Shard] = None):
    """Clipped-surrogate loss over full sequences (BPTT). With ``shard``,
    ``batch`` is a rank's part of a minibatch: every mean is the local sum
    over the global count, the advantages are normalized by the global
    statistics and the entropy term is weighted by the rank's share, so the
    loss and metrics summed over the ranks are the whole minibatch's."""
    seq = ppo_cfg.policy_mod.sequence(params, batch.obs, batch.dones_before,
                                      batch.init_lstm_state)
    nlp = lstm.neglogp(seq.mean, seq.logstd, batch.actions)          # (T,B)
    ent = torch.mean(lstm.entropy(seq.logstd))
    vpred = seq.value

    advs = batch.returns - batch.values
    if shard is None:
        mean = torch.mean
        # population statistics (ddof = 0), as numpy and jax.numpy default to
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    else:
        def mean(x):
            return torch.sum(x) / shard.n
        advs = (advs - shard.adv_mean) / (shard.adv_std + 1e-8)
        ent = ent * shard.share

    vpred_clipped = batch.values + torch.clamp(vpred - batch.values,
                                               -ppo_cfg.clip_range, ppo_cfg.clip_range)
    vf_loss = 0.5 * mean(torch.maximum((vpred - batch.returns) ** 2,
                                       (vpred_clipped - batch.returns) ** 2))
    ratio = torch.exp(batch.neglogpacs - nlp)
    pg1 = -advs * ratio
    pg2 = -advs * torch.clamp(ratio, 1.0 - ppo_cfg.clip_range, 1.0 + ppo_cfg.clip_range)
    pg_loss = mean(torch.maximum(pg1, pg2))
    loss = pg_loss - ent * ppo_cfg.ent_coef + vf_loss * ppo_cfg.vf_coef

    with torch.no_grad():
        approxkl = 0.5 * mean((nlp - batch.neglogpacs) ** 2)
        clipfrac = mean((torch.abs(ratio - 1.0) > ppo_cfg.clip_range).to(ratio.dtype))
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


_LOSS_TERMS = ("pg_loss", "vf_loss", "entropy", "approxkl", "clipfrac")


def train_minibatch(params: lstm.PolicyParams, opt: torch.optim.Adam, mb: Optional[Batch],
                    ppo_cfg: PPOConfig, mesh: Optional[pmesh.Mesh] = None,
                    shard: Optional[Shard] = None) -> dict:
    """One optimizer step on one minibatch: loss, gradients (BPTT), the
    global-norm clip, Adam. Returns the step's metrics as 0-d tensors, the
    gradient's global norm before the clip among them. With ``mesh``, ``mb``
    is this rank's part (``shard``; None if it owns no env of the
    minibatch, and then it runs no forward but joins the all-reduce with
    zeros) and one all-reduce sums the gradients, the loss and its terms."""
    with profiling.span("ppo.minibatch"):
        opt.zero_grad(set_to_none=True)
        if mb is not None:
            loss, aux = ppo_loss(params, mb, ppo_cfg, shard)
            with profiling.span("ppo.backward"):
                loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=params.pi_w.device)
            aux = {k: torch.zeros_like(loss) for k in _LOSS_TERMS}
        with profiling.span("ppo.adam"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params.leaves()]
            if mesh is not None:
                flat = pmesh.all_reduce_sum(mesh, torch.cat(
                    [g.flatten() for g in grads]
                    + [torch.stack([loss] + [aux[k] for k in _LOSS_TERMS])]))
                n_terms = 1 + len(_LOSS_TERMS)
                for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads]
                                                      + [n_terms])):
                    g.copy_(part.view_as(g))
                loss, *terms = flat[-n_terms:].unbind()
                aux = dict(zip(_LOSS_TERMS, terms))
            for p, g in zip(params.leaves(), grads):
                p.grad = g
            grad_norm = clip_by_global_norm_(grads, ppo_cfg.max_grad_norm)
            opt.step()
        return {"loss": loss, **aux, "grad_norm": grad_norm}


def _mean_metrics(rows: list) -> dict:
    return {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}


def _sharded_epoch(params, opt: torch.optim.Adam, batch: Batch, ppo_cfg: PPOConfig,
                   mesh: pmesh.Mesh, perm: torch.Tensor) -> list:
    """One epoch of a rank: ``perm`` (nminibatches, envs a minibatch) holds
    global env indices; the rank trains on those of its block. The
    advantages' global mean of every minibatch comes first, then their
    global centred sums of squares (two all-reduces an epoch)."""
    lo, hi = pmesh.block(mesh, perm.numel())
    n = batch.obs.shape[0] * perm.shape[1]
    mbs = []
    for idx in perm:
        own = idx[(idx >= lo) & (idx < hi)] - lo
        mbs.append((_select_envs(batch, own) if own.numel() else None, own.numel()))
    zero = torch.zeros((), device=batch.obs.device)
    advs = [None if mb is None else mb.returns - mb.values for mb, _ in mbs]
    adv_mean = pmesh.all_reduce_sum(
        mesh, torch.stack([zero if a is None else a.sum() for a in advs])) / n
    adv_std = torch.sqrt(pmesh.all_reduce_sum(mesh, torch.stack(
        [zero if a is None else ((a - m) ** 2).sum() for a, m in zip(advs, adv_mean)])) / n)
    return [train_minibatch(params, opt, mb, ppo_cfg, mesh,
                            Shard(n, adv_mean[j], adv_std[j], k / perm.shape[1]))
            for j, (mb, k) in enumerate(mbs)]


def train_epochs(params, opt: torch.optim.Adam, batch: Batch, ppo_cfg: PPOConfig,
                 gen: torch.Generator, n_envs: int, mesh: Optional[pmesh.Mesh] = None) -> list:
    """``ppo_cfg.noptepochs`` epochs on a rollout's ``batch``, each a
    permutation of the ``n_envs`` envs drawn from ``gen`` and cut into
    ``nminibatches`` steps; returns each epoch's mean metrics. With ``mesh``,
    ``batch`` is this rank's block of the ``n_envs`` and the permutation the
    global one."""
    dev = batch.obs.device
    epochs = []
    for _ in range(ppo_cfg.noptepochs):
        perm = dev_mod.randperm(gen, n_envs, dev).reshape(ppo_cfg.nminibatches, -1)
        epochs.append(_mean_metrics(
            _sharded_epoch(params, opt, batch, ppo_cfg, mesh, perm) if mesh is not None else
            [train_minibatch(params, opt, _select_envs(batch, idx), ppo_cfg) for idx in perm]))
    return epochs


@torch.no_grad()
def _batch_metrics(batch: Batch, ep: EpStats, z_scale: Optional[torch.Tensor]) -> dict:
    """The update's metrics of the rollout's batch (unsharded)."""
    # explained variance (logger parity, ppo2.py:424-435)
    var_y = torch.var(batch.returns, correction=0)
    out = {"explained_variance": 1.0 - torch.var(
        batch.returns - batch.values, correction=0) / (var_y + 1e-8)}
    # true episode bookkeeping: mean return/length over episodes that
    # terminated this rollout (= the reference's safe_mean over ep_info_buf,
    # ppo2.py:424-428); NaN-free when nothing terminated
    count = torch.clamp(ep.count, min=1.0)
    out["ep_rew_mean"] = ep.ret_sum / count
    out["ep_len_mean"] = ep.len_sum / count
    out["ep_count"] = ep.count
    out["reward_per_step"] = torch.mean(batch.rewards)
    if z_scale is not None:
        out["terrain_z_scale"] = z_scale
    return out


@torch.no_grad()
def _sharded_batch_metrics(mesh: pmesh.Mesh, batch: Batch, ep: EpStats,
                           z_sum: Optional[torch.Tensor], n_envs: int) -> dict:
    """:func:`_batch_metrics` over every rank's batch, from global sums and
    counts (``z_sum``: this rank's sum of the terrain scale): means first,
    then centred sums of squares."""
    n = batch.rewards.shape[0] * n_envs
    resid = batch.returns - batch.values
    zero = torch.zeros((), device=batch.obs.device)
    s = pmesh.all_reduce_sum(mesh, torch.stack([
        batch.returns.sum(), resid.sum(), batch.rewards.sum(), ep.ret_sum, ep.len_sum,
        ep.count, zero if z_sum is None else z_sum]))
    mean_y, mean_r = s[0] / n, s[1] / n
    css = pmesh.all_reduce_sum(mesh, torch.stack([((batch.returns - mean_y) ** 2).sum(),
                                                  ((resid - mean_r) ** 2).sum()]))
    count = torch.clamp(s[5], min=1.0)
    out = {"explained_variance": 1.0 - (css[1] / n) / (css[0] / n + 1e-8),
           "ep_rew_mean": s[3] / count, "ep_len_mean": s[4] / count, "ep_count": s[5],
           "reward_per_step": s[2] / n}
    if z_sum is not None:
        out["terrain_z_scale"] = s[6] / n_envs
    return out


def make_update_fn(env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                   mesh: Optional[pmesh.Mesh] = None) -> Callable:
    """One full PPO update: rollout + noptepochs x env-shuffled minibatches.

    Returns a function TrainState -> (TrainState, metrics dict of 0-d tensors
    and floats). Beside the JAX package's metrics it reports the mean loss of
    the first and of the last epoch (``loss_first_epoch``,
    ``loss_last_epoch``), the wall seconds of the update's three parts
    (``time_rollout_s``, ``time_gae_s``, ``time_epochs_s``) and, on a terrain
    config, the mean terrain height scale of its rollout
    (``terrain_z_scale``). With ``mesh`` the state is a rank's shard
    (``parallel.train.shard_train_state``) of ``env_cfg.num_envs`` envs,
    every metric but the times is global, and ``time_collectives_s`` is the
    part of the times spent in collectives.
    """
    n_envs = env_cfg.num_envs
    if n_envs % ppo_cfg.nminibatches:
        raise ValueError("num_envs must be divisible by nminibatches")
    if mesh is not None and n_envs % mesh.world:
        raise ValueError(f"num_envs {n_envs} must divide evenly across the {mesh.world} ranks")

    @profiling.span("ppo.update")
    def update(ts: TrainState):
        timings: dict = {}
        comm_s = mesh.seconds["collectives"] if mesh is not None else 0.0
        terr = ts.env_state.terrain if env_cfg.terrain else None
        z_scale = None if terr is None else terr.z_scale.sum() if mesh else terr.z_scale.mean()
        ts, batch, ep = rollout(env_cfg, ppo_cfg, ts, timings)
        dev = batch.obs.device
        with profiling.span("ppo.epochs"):
            t0 = _clock(dev)
            epochs = train_epochs(ts.params, ts.opt_state, batch, ppo_cfg, ts.gen_train, n_envs,
                                  mesh)
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
            if mesh is not None:
                metrics.update(_sharded_batch_metrics(mesh, batch, ep, z_scale, n_envs))
                metrics["time_collectives_s"] = mesh.seconds["collectives"] - comm_s
            else:
                metrics.update(_batch_metrics(batch, ep, z_scale))
            epochs_s = _clock(dev) - t0
        metrics["time_rollout_s"] = timings["rollout_s"]
        metrics["time_gae_s"] = timings["gae_s"]
        metrics["time_epochs_s"] = epochs_s
        ts.update_idx += 1
        return ts, metrics

    return update


def learn(env_cfg: EnvConfig, ppo_cfg: PPOConfig, total_timesteps: int,
          seed: int, params: Optional[lstm.PolicyParams] = None,
          eval_every_n: int = 100, callback=None, verbose: bool = True,
          metrics_hook=None, opt_state: Optional[dict] = None, state_hook=None,
          device=None, mesh: Optional[pmesh.Mesh] = None) -> TrainState:
    """Training loop (PPO2.learn parity: periodic eval hook + checkpointing
    are the caller's callback, mirroring ppo2.py:331-341; ``metrics_hook``
    fires every update: the CLI uses it to persist metrics.jsonl).
    ``opt_state`` restores Adam from a checkpoint's plain dict
    (``models.io.load_checkpoint``), its learning rate included, as the JAX
    package's resume does; env/LSTM states re-init fresh, which is
    sound for on-policy PPO. ``state_hook(ts, frac) -> ts`` runs before each
    update with the run fraction in [0, 1]. With ``mesh`` every rank builds
    the world-1 state on ``mesh.device``, checks that its parameters are the
    other ranks' and trains its shard (``parallel.train.shard_train_state``);
    the metrics are global, and the caller keeps the hooks to one rank."""
    ts = init_train_state(env_cfg, ppo_cfg, seed, params,
                          device if mesh is None else mesh.device)
    if opt_state is not None and not mio.adam_state_from_numpy(ts.opt_state, ts.params,
                                                               opt_state):
        print("resume: checkpoint optimizer state has a different "
              "structure (other parameter shapes); starting Adam fresh")
    if mesh is not None:
        # parallel.train builds on this module
        from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import train as ptrain
        pmesh.replicated(mesh, ts.params.leaves(), "parameters")
        ts = ptrain.shard_train_state(mesh, ts)
    update_fn = make_update_fn(env_cfg, ppo_cfg, mesh)
    batch_size = env_cfg.num_envs * ppo_cfg.n_steps
    n_updates = max(1, total_timesteps // batch_size)
    try:
        for i in range(n_updates):
            if state_hook is not None:
                ts = state_hook(ts, i / max(n_updates - 1, 1))
            if ppo_cfg.lr_final is not None:
                lr_i = scheduled_lr(ppo_cfg, i / max(n_updates - 1, 1))
                with_learning_rate(ts.opt_state, lr_i)
            ts, metrics = update_fn(ts)
            if verbose or callback or metrics_hook:
                metrics = {k: float(v) for k, v in metrics.items()}
                # env steps over the update's own synchronized times
                metrics["fps"] = batch_size / max(metrics["time_rollout_s"] + metrics["time_gae_s"]
                                                  + metrics["time_epochs_s"], 1e-9)
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
