"""Robustness quantification: disturbance-recovery rate fits.

Port of ``analysis/robustness.py``. The reference's Figure-4 analysis
(Data_Visualization_Code/Figure4.py:330-392) quantifies controller robustness
as an exponential *recovery rate* kappa (log_e/s, plotted in [-10, 2]): after
a disturbance the velocity deviation decays as |v(t) - v_ss| ~ A exp(kappa t);
kappa < 0 recovers, more negative = faster. The experiment is generated on
the device, a batch of closed-loop rollouts with a base-velocity kick injected
mid-flight (the state_disturbance capability, Environment.hpp:912-940), and
fitted on the host with numpy.

Also the velocity-vs-latency curve with a kappa fit per latency (the DelayTool
sweep of run_bp_v5.py:360-365 crossed with recovery fits), and the
reference's own estimator: the decay of an episode ensemble's entropy.

The JAX package steps its per-env ``bp.step`` here (robustness.py:63, :281).
The port steps ``step_batch`` (the fused physics kernel) unless the config
asks for hard contact or the meteorite attacks, as
:func:`..analysis.eval.policy_rollout` does; :func:`recovery_sweep` rolls all
(command, kick) pairs as one batch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import (
    euler2qua,
    qua2euler,
    quat_to_matrix,
)


class KickLog(NamedTuple):
    """Per-step traces, (T, ...) for one rollout or (T, B, ...) for B."""
    v_body: torch.Tensor   # (T, [B,] 3) body-frame velocity
    z: torch.Tensor        # (T, [B])
    done: torch.Tensor     # (T, [B])


def _start(cfg: EnvConfig, params, cmd: torch.Tensor, gen: torch.Generator, device):
    """Deployment-style start of B = len(cmd) envs at their commands, on
    terrain all on one map offset (or analytic seed) drawn from ``gen``: (state, zero LSTM
    state, normalized command)."""
    B = cmd.shape[0]
    offset, seed = ev.shared_terrain(cfg, B, gen, device)
    state = bp.env_init(cfg, B, gen, device, offset, seed).replace(command=cmd,
                                                                   command_filtered=cmd)
    s_size = lstm.state_size([w.wh.shape[-2] for w in params.pi_lstm])
    cmd_n = (cmd - bp.obs_mean(cfg, device)[:3]) / bp.obs_std(cfg, device)[:3]
    return state, torch.zeros((B, s_size), device=device), cmd_n


def _body_frame(state: bp.EnvState, lo: int) -> torch.Tensor:
    """R^T gv[lo:lo + 3]: a base velocity in the body frame, (B, 3)."""
    R = quat_to_matrix(state.gc[:, 3:7])
    return torch.einsum("bji,bj->bi", R, state.gv[:, lo:lo + 3])


def _kick_rollout(cfg: EnvConfig, params: lstm.PolicyParams, command, kick_dv,
                  gen: torch.Generator, n_steps: int, kick_step: int, delay_steps: int,
                  device) -> KickLog:
    device = dev_mod.resolve(device)
    cfg = ev._fixed_command_cfg(cfg)
    cmd = dev_mod.tensor(command, device)
    single = cmd.dim() == 1
    cmd = cmd.reshape(-1, 3)
    B = cmd.shape[0]
    dv = dev_mod.tensor(kick_dv, device).reshape(-1, 6).expand(B, 6)
    kick = torch.cat([dv, torch.zeros((B, 12), device=device)], dim=-1)
    state, lstm_state, cmd_n = _start(cfg, params, cmd, gen, device)
    obs = bp.observe(cfg, state)
    no_reset = torch.zeros(B, device=device)
    env_step = ev.env_step(cfg)
    buf = [obs] * max(delay_steps, 1)
    v_body, z, done = [], [], []
    for idx in range(n_steps):
        if idx == kick_step:
            state = state.replace(gv=state.gv + kick)
        if delay_steps > 0:
            delayed, buf[idx % delay_steps] = buf[idx % delay_steps], obs
        else:
            delayed = obs
        o = torch.cat([cmd_n, delayed[:, 3:]], dim=-1)
        action, lstm_state = lstm.deterministic_action(params, o, lstm_state, no_reset)
        out = env_step(cfg, state.replace(command=cmd, command_filtered=cmd), action, gen)
        state, obs = out.state, out.obs
        v_body.append(_body_frame(state, 0))
        z.append(state.gc[:, 2])
        done.append(out.done)
    log = KickLog(torch.stack(v_body), torch.stack(z), torch.stack(done))
    return KickLog(*(t[:, 0] for t in log)) if single else log


def kick_rollout(cfg: EnvConfig, params: lstm.PolicyParams, command, kick_dv,
                 gen: torch.Generator, n_steps: int = 1500, kick_step: int = 750,
                 device=None) -> KickLog:
    """Closed-loop rollout with a base-velocity kick at ``kick_step``.

    command: (3,) for one env or (B, 3) for B envs stepped as one batch;
    kick_dv: (6,) or (B, 6) generalized-velocity impulse [dvx dvy dvz dwx dwy
    dwz] added to the base DoFs in one control step (a harder version of the
    manual-mode state_disturbance kicks). ``gen`` lives on ``device``."""
    return _kick_rollout(cfg, params, command, kick_dv, gen, n_steps, kick_step, 0, device)


def _kick_rollout_delayed(cfg: EnvConfig, params, command, kick_dv, gen, n_steps, kick_step,
                          delay_steps, device=None) -> KickLog:
    """kick_rollout with an observation FIFO of delay_steps control steps."""
    return _kick_rollout(cfg, params, command, kick_dv, gen, n_steps, kick_step, delay_steps,
                         device)


def fit_kappa(v: np.ndarray, dt: float, kick_step: int,
              settle: int = 50, window: int = 400) -> dict:
    """Log-linear fit of the deviation decay after a kick.

    v: (T,) the velocity component of interest. v_ss is estimated from the
    pre-kick steady state; the fit regresses log|v - v_ss| on t over
    [kick+settle, kick+window] (the settle skip avoids the impulsive
    transient the exponential model does not describe).
    Returns {kappa [log_e/s], r2, v_ss, dev0}."""
    v_ss = float(np.mean(v[max(kick_step - 200, 0):kick_step]))
    dev = np.abs(v[kick_step:] - v_ss)
    dev0 = float(dev[:settle].max(initial=1e-9))
    seg = dev[settle:window]
    seg = np.clip(seg, 1e-4, None)
    t = np.arange(settle, window) * dt
    y = np.log(seg)
    A = np.stack([t, np.ones_like(t)], axis=1)
    coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - float(res[0]) / ss_tot if res.size and ss_tot > 0 else 0.0
    return {"kappa": float(coef[0]), "r2": r2, "v_ss": v_ss, "dev0": dev0}


def recovery_sweep(cfg: EnvConfig, params, commands: Sequence[float],
                   kicks: Sequence[float], gen: torch.Generator, n_steps: int = 1500,
                   kick_step: int = 750, axis: int = 1, device=None) -> list:
    """Recovery-rate experiment grid: forward commands x lateral kick sizes,
    every (command, kick) pair an env of one batch.

    axis: which base-velocity component the kick hits (default 1 = lateral,
    the classic push-recovery test). Returns one row per (command, kick)
    with the fitted kappa, survival flag, and steady-state speed."""
    dt = cfg.control_dt
    sign = -1.0 if cfg.wildcat else 1.0
    pairs = [(float(vx), float(k)) for vx in commands for k in kicks]
    cmds = np.array([[vx, 0.0, 0.0] for vx, _ in pairs])
    dvs = np.zeros((len(pairs), 6))
    dvs[:, axis] = [k for _, k in pairs]
    log = kick_rollout(cfg, params, cmds, dvs, gen, n_steps, kick_step, device=device)
    v_body = log.v_body.cpu().numpy()
    done = log.done.cpu().numpy()
    rows = []
    for b, (vx, kmag) in enumerate(pairs):
        fit = fit_kappa(v_body[:, b, axis], dt, kick_step)
        vfwd = sign * v_body[:, b, 0]
        rows.append({"command": vx, "kick": kmag,
                     "kappa": fit["kappa"], "r2": fit["r2"],
                     "survived": not bool(done[kick_step:, b].any()),
                     "v_fwd_ss": float(vfwd[kick_step - 200:kick_step].mean())})
    return rows


def latency_recovery(cfg: EnvConfig, params, vx: float, delays_steps: Sequence[int],
                     kick: float, gen: torch.Generator, n_steps: int = 1500,
                     kick_step: int = 750, device=None) -> list:
    """Velocity + recovery rate vs control latency (Figure4.py:330-392).

    At each injected latency, the achieved forward speed (no kick) and the
    lateral-kick recovery rate kappa of the loop whose observation path
    carries the FIFO."""
    rows = []
    sign = -1.0 if cfg.wildcat else 1.0
    for d in delays_steps:
        log = ev.policy_rollout(ev._fixed_command_cfg(cfg), params, np.array([vx, 0.0, 0.0]),
                                gen, n_steps, delay_steps=int(d), device=device)
        vb = ev.body_velocity(log)[int(n_steps * 0.6):]
        dv = np.zeros(6)
        dv[1] = kick
        klog = _kick_rollout_delayed(cfg, params, np.array([vx, 0.0, 0.0]), dv, gen, n_steps,
                                     kick_step, int(d), device)
        fit = fit_kappa(klog.v_body[:, 1].cpu().numpy(), cfg.control_dt, kick_step)
        died = bool(klog.done[kick_step:].any())
        rows.append({"latency_ms": float(d) * cfg.control_dt * 1e3,
                     "v_mean": float(sign * vb[:, 0].mean()),
                     "kappa": fit["kappa"], "survived": not died})
    return rows


# --- the reference's OWN kappa estimator: ensemble-entropy decay ----------
#
# Figure4.py:160-167 + :294-340 quantify recovery as the decay rate of the
# Shannon entropy of an episode ENSEMBLE in a quantized 6-d body-state space
# [z, roll, pitch, z_dot^B, roll_dot^B, pitch_dot^B]: thousands of episodes
# start with randomized body-state noise, the per-frame ensemble entropy
# contracts as the controller re-converges, and kappa is the slope of the
# linear (log_e) segment of a piecewise flat-linear-flat fit.

ENTROPY_LB = np.array([0.0, -3.14, -1.57, -10.0, -10.0, -10.0])
ENTROPY_UB = np.array([0.5, 3.14, 1.57, 10.0, 10.0, 10.0])
ENTROPY_PRECISION = np.array([0.005, 0.02, 0.02, 0.005, 0.025, 0.025])
# the Param-file noise protocol (e.g. Param-2021-06-22-15-07-36.txt):
# z 0.02 m, roll/pitch 0.25 rad, z_dot/roll_dot/pitch_dot 1.0
ENTROPY_NOISE = np.array([0.02, 0.25, 0.25, 1.0, 1.0, 1.0])


def ensemble_entropy(x: np.ndarray, lb=ENTROPY_LB, ub=ENTROPY_UB,
                     precision=ENTROPY_PRECISION) -> float:
    """Shannon entropy (nats) of one frame's episode ensemble (N, 6) in the
    reference's quantized state cells (Figure4.py:160-167)."""
    q = (np.clip(x, lb, ub) / precision).astype(np.int32)
    _, freq = np.unique(q, axis=0, return_counts=True)
    p = freq / x.shape[0]
    return float(-np.sum(p * np.log(p)))


def piecewise_flat_linear_flat(x, a, b, c, d):
    """Figure4.py:169-173: constant b until a, slope d on [a, c], flat after."""
    x = np.asarray(x, dtype=float)
    y = np.where(x <= a, b,
                 np.where(x <= c, d * (x - a) + b, d * (c - a) + b))
    return y


def fit_entropy_kappa(t: np.ndarray, ent: np.ndarray) -> dict:
    """curve_fit of the piecewise model with the reference's bounds
    (Figure4.py:318-336); kappa = the linear-segment slope d [log_e/s]."""
    from scipy.optimize import curve_fit

    lb = np.array([0.0, 0.0, 1e-3, -20.0])
    ub = np.array([1.0, max(10.0, float(ent.max()) * 2), 2.0, 2.0])
    p, cov = curve_fit(piecewise_flat_linear_flat, np.asarray(t, float),
                       np.asarray(ent, float), bounds=(lb, ub), maxfev=20000)
    err = np.sqrt(np.diag(cov))
    return {"kappa": float(p[3]), "kappa_err": float(err[3]),
            "a": float(p[0]), "b": float(p[1]), "c": float(p[2]),
            "popt": p, "pcov": cov}


def entropy_noise(gen: torch.Generator, n_episodes: int, device=None) -> torch.Tensor:
    """The ensemble's unit noise draw, uniform in [-1, 1), (N, 6): one row an
    episode over [z, roll, pitch, z_dot, roll_dot, pitch_dot], scaled by
    ENTROPY_NOISE in :func:`entropy_ensemble_rollout`."""
    device = dev_mod.resolve(device)
    return torch.rand((n_episodes, 6), generator=gen, device=device) * 2.0 - 1.0


def _features(state: bp.EnvState) -> torch.Tensor:
    """6 entropy features + v_x^B as a 7th column (performance axis), (N, 7)."""
    e = qua2euler(state.gc[:, 3:7])
    vb, wb = _body_frame(state, 0), _body_frame(state, 3)
    return torch.stack([state.gc[:, 2], e[:, 0], e[:, 1], vb[:, 2], wb[:, 0], wb[:, 1],
                        vb[:, 0]], dim=-1)


def entropy_ensemble_rollout(cfg: EnvConfig, params, command, gen: torch.Generator,
                             n_episodes: int = 4096, n_steps: int = 500, skip: int = 5,
                             delay_steps: int = 0, device=None, u=None):
    """The Figure-4 disturbance-ensemble experiment as ONE batch.

    Every episode starts from the commanded gait with uniform body-state
    noise of the Param protocol (ENTROPY_NOISE) injected into
    [z, roll, pitch, z_dot, roll_dot, pitch_dot]; the closed loop then runs
    n_steps and the 6 entropy features (+ v_x^B as column 7) are recorded
    every ``skip`` control steps. The base state (gait phase, joint pose) is
    SHARED across the ensemble: episodes differ only by the noise, the unit
    draw ``u`` (N, 6) in [-1, 1] (default :func:`entropy_noise` from ``gen``).
    Returns (features (F, N, 7), died (N,)) with F = ceil(n_steps/skip)."""
    device = dev_mod.resolve(device)
    cfg = ev._fixed_command_cfg(cfg)
    command = dev_mod.tensor(command, device).reshape(3)
    u = entropy_noise(gen, n_episodes, device) if u is None else dev_mod.tensor(u, device)
    if tuple(u.shape) != (n_episodes, 6):
        raise ValueError(f"u must be ({n_episodes}, 6), got {tuple(u.shape)}")
    u = u * dev_mod.tensor(ENTROPY_NOISE, device)
    cmd = command.expand(n_episodes, 3)
    # the manual start is the same state for every env of a batch (on terrain
    # one map offset for all), so every episode starts from one base state
    state, lstm_state, cmd_n = _start(cfg, params, cmd, gen, device)
    e = qua2euler(state.gc[:, 3:7])
    q = euler2qua(torch.stack([e[:, 0] + u[:, 1], e[:, 1] + u[:, 2], e[:, 2]], dim=-1))
    gc = torch.cat([state.gc[:, :2], state.gc[:, 2:3] + u[:, 0:1], q, state.gc[:, 7:]], dim=-1)
    gv = torch.cat([state.gv[:, :2], state.gv[:, 2:5] + u[:, 3:6], state.gv[:, 5:]], dim=-1)
    state = state.replace(gc=gc, gv=gv)
    obs = bp.observe(cfg, state)
    no_reset = torch.zeros(n_episodes, device=device)
    env_step = ev.env_step(cfg)
    buf = [obs] * max(delay_steps, 1)
    died = torch.zeros(n_episodes, dtype=torch.bool, device=device)
    feats = []
    for idx in range(n_steps):
        if delay_steps > 0:
            delayed, buf[idx % delay_steps] = buf[idx % delay_steps], obs
        else:
            delayed = obs
        o = torch.cat([cmd_n, delayed[:, 3:]], dim=-1)
        action, lstm_state = lstm.deterministic_action(params, o, lstm_state, no_reset)
        out = env_step(cfg, state.replace(command=cmd, command_filtered=cmd), action, gen)
        state, obs = out.state, out.obs
        died = died | out.done
        if idx % skip == 0:
            feats.append(_features(state))
    return torch.stack(feats), died


def entropy_kappa(cfg: EnvConfig, params, command, gen: torch.Generator,
                  n_episodes: int = 4096, n_steps: int = 500,
                  skip: int = 5, delay_steps: int = 0, device=None) -> dict:
    """End-to-end Figure-4 kappa: ensemble rollout -> per-frame entropy ->
    piecewise fit. Returns the fit dict + t/entropy arrays + survival."""
    feats, died = entropy_ensemble_rollout(cfg, params, command, gen, n_episodes, n_steps,
                                           skip, delay_steps, device)
    feats = feats.cpu().numpy()
    t = np.arange(feats.shape[0]) * cfg.control_dt * skip
    ent = np.array([ensemble_entropy(f[:, :6]) for f in feats])
    fit = fit_entropy_kappa(t, ent)
    sign = -1.0 if cfg.wildcat else 1.0
    vx = sign * feats[int(feats.shape[0] * 0.6):, :, 6]
    fit.update(t=t, entropy=ent,
               v_mean=float(vx.mean()), v_err=float(vx.std()),
               survival=float(1.0 - died.float().mean().item()),
               latency_ms=delay_steps * cfg.control_dt * 1e3)
    return fit
