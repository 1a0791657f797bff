"""Closed-loop evaluation of a trained controller.

Port of ``analysis/eval.py`` (run_bp_v5.py:261-1120): :func:`policy_rollout`
runs the LSTM controller in closed loop at fixed commands, one env per
command, all envs in one batch, and is the data source of every mode below;
:func:`tracking_eval` turns it into velocity-tracking statistics per command
(run_bp_v5.py:738-818); :func:`torque_power` (torque, power, TCoT,
:846-914), :func:`work_condition` (the motor envelope, :916-1030),
:func:`state_space` (phase portraits, :520-662), :func:`latency_sweep` (the
DelayTool sweep, :360-365), :func:`lstm_state_correlation` (:1032-1088),
:func:`value_pca` (:820-844), :func:`spectrogram` (:1090-1117),
:func:`toe_trajectories` (:692-736) and :func:`energy_data` (:446-511) are
the analysis modes of ``cli/test.py``. Host-side statistics are numpy, as in
the JAX package. Each env of a batch computes exactly what a rollout of its
command alone computes. On a terrain config every env of a rollout starts on
the same stretch of the heightmap, as the JAX package's rollouts of one key
do, unless the caller gives each env its map offset.

The JAX package's rollout steps its per-env ``bp.step`` (eval.py:87). The
port steps ``step_batch`` (the fused physics kernel) where it can, and the
per-env ``step`` under hard contact or the meteorite attacks, which
``step_batch`` does not run (``scripts/hard_contact_eval.py``'s protocol:
``HardContact: true``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain as tr
from high_speed_quadrupedal_locomotion_by_irrl_torch.robot import kinematics
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.rotation import quat_to_matrix


class RolloutLog(NamedTuple):
    """Per-step traces, (T, ...) for one command or (T, B, ...) for B."""
    gc: torch.Tensor            # (T, [B,] 19)
    gv: torch.Tensor            # (T, [B,] 18)
    torque: torch.Tensor        # (T, [B,] 12) applied joint torques [Nm]
    action: torch.Tensor        # (T, [B,] 12)
    obs: torch.Tensor           # (T, [B,] 35) normalized
    reward: torch.Tensor        # (T, [B])
    done: torch.Tensor          # (T, [B])
    contact: torch.Tensor       # (T, [B,] 4)
    command: torch.Tensor       # (T, [B,] 3)
    lstm_state: torch.Tensor    # (T, [B,] S)
    joint_ref: torch.Tensor     # (T, [B,] 12)


def _fixed_command_cfg(cfg: EnvConfig) -> EnvConfig:
    """Deployment-style env: no resampling noise sources."""
    return cfg.replace(manual=True, obs_noise=0.0, action_noise=0.0,
                       stochastic_dynamics=False)


def env_step(cfg: EnvConfig):
    """The env step the analysis rollouts take: ``step_batch`` (the physics
    kernel), or the per-env ``step`` under hard contact or the attacks,
    which ``step_batch`` does not run."""
    return bp.step if cfg.hard_contact or cfg.crucial else bp.step_batch


def shared_terrain(cfg: EnvConfig, B: int, gen: torch.Generator, device, terrain_offset=None,
                   terrain_seed=None):
    """(terrain_offset, terrain_seed) for env_init: on a terrain config with
    neither given, one map offset (the sampled heightmap) or one seed (the
    analytic fractal) drawn from ``gen`` for all B envs."""
    if cfg.terrain and terrain_offset is None and terrain_seed is None:
        if cfg.terrain_sampled:
            terrain_offset = tr.sampled_fractal(gen, 1, cfg.terrain_z_scale,
                                                device).offset.expand(B, 2)
        else:
            terrain_seed = tr.fractal(gen, 1, cfg.terrain_z_scale, device).seed.expand(B)
    return terrain_offset, terrain_seed


def policy_rollout(cfg: EnvConfig, params: lstm.PolicyParams, command,
                   gen: torch.Generator, n_steps: int = 750, delay_steps: int = 0,
                   device=None, terrain_offset=None, terrain_seed=None) -> RolloutLog:
    """Closed-loop rollout of the LSTM controller at fixed commands.

    command: (3,) for one env or (B, 3) for B envs stepped as one batch.
    ``gen`` must live on ``device`` (default ``cuda``). delay_steps > 0
    inserts an observation FIFO of that many control steps (the DelayTool
    latency experiment, run_bp_v5.py:360-365). On a terrain config all envs
    share one map offset (or analytic seed) drawn from ``gen``, or
    ``terrain_offset`` (B, 2) (``terrain_seed`` (B,)) gives each env its own."""
    device = dev_mod.resolve(device)
    cmd = dev_mod.tensor(command, device)
    single = cmd.dim() == 1
    cmd = cmd.reshape(-1, 3)
    B = cmd.shape[0]
    terrain_offset, terrain_seed = shared_terrain(cfg, B, gen, device, terrain_offset,
                                                  terrain_seed)
    state = bp.env_init(cfg, B, gen, device, terrain_offset, terrain_seed).replace(
        command=cmd, command_filtered=cmd)
    obs = bp.observe(cfg, state)
    s_size = lstm.state_size([w.wh.shape[0] for w in params.pi_lstm])
    step = env_step(cfg)
    lstm_state = torch.zeros((B, s_size), device=device)
    no_reset = torch.zeros(B, device=device)
    cmd_n = (cmd - bp.obs_mean(cfg, device)[:3]) / bp.obs_std(cfg, device)[:3]
    buf = [obs] * max(delay_steps, 1)

    logs = {k: [] for k in RolloutLog._fields}
    for idx in range(n_steps):
        if delay_steps > 0:
            delayed, buf[idx % delay_steps] = buf[idx % delay_steps], obs
        else:
            delayed = obs
        delayed = torch.cat([cmd_n, delayed[:, 3:]], dim=-1)  # manual-mode command injection
        action, lstm_state = lstm.deterministic_action(params, delayed, lstm_state, no_reset)
        out = step(cfg, state.replace(command=cmd, command_filtered=cmd), action, gen)
        state, obs = out.state, out.obs
        for k, v in (("gc", state.gc), ("gv", state.gv), ("torque", state.torque_applied),
                     ("action", action), ("obs", obs), ("reward", out.reward),
                     ("done", out.done), ("contact", state.contact_filtered),
                     ("command", cmd), ("lstm_state", lstm_state),
                     ("joint_ref", state.joint_ref)):
            logs[k].append(v)
    stacked = {k: torch.stack(v) for k, v in logs.items()}
    if single:
        stacked = {k: v[:, 0] for k, v in stacked.items()}
    return RolloutLog(**stacked)


def body_velocity(log: RolloutLog) -> np.ndarray:
    """(T, [B,] 3) body-frame linear velocity from the log."""
    R = quat_to_matrix(log.gc[..., 3:7])
    return torch.einsum("...ji,...j->...i", R, log.gv[..., :3]).cpu().numpy()


def tracking_eval(cfg: EnvConfig, params, commands, gen: torch.Generator,
                  n_steps: int = 2000, skip=None, device=None):
    """Velocity-tracking error stats per command (run_bp_v5.py:738-818).

    All commands roll as one batch (on terrain, from one map offset).
    Steady-state stats use the trailing 40% of the rollout unless ``skip`` (in
    control steps) is given. Each row also counts the env's falls
    (terminations) over the whole rollout."""
    cmds = np.array([[float(vx), 0.0, 0.0] for vx in commands])
    log = policy_rollout(_fixed_command_cfg(cfg), params, cmds, gen, n_steps, device=device)
    return tracking_rows(cfg, log, commands, skip)


def tracking_rows(cfg: EnvConfig, log: RolloutLog, commands, skip=None):
    """:func:`tracking_eval`'s rows from the log of a batched rollout at the
    forward speeds ``commands``, one an env."""
    n_steps = log.gc.shape[0]
    cmds = np.array([[float(vx), 0.0, 0.0] for vx in commands])
    vb = body_velocity(log)[skip if skip is not None else int(n_steps * 0.6):]  # (T', B, 3)
    falls = log.done.sum(dim=0).cpu().numpy()
    sign = -1.0 if cfg.wildcat else 1.0
    rows = []
    for b, vx in enumerate(cmds[:, 0]):
        v = vb[:, b, 0]
        err = sign * v - vx
        rows.append({"command": float(vx), "v_mean": float((sign * v).mean()),
                     "v_std": float(v.std()), "err_mean": float(err.mean()),
                     "err_std": float(err.std()), "falls": int(falls[b])})
    return rows


def numpy_log(log: RolloutLog) -> RolloutLog:
    """The log with every field as a numpy array on the host (what
    :mod:`.figures` and :mod:`..analysis.rawdata` take)."""
    return RolloutLog(*(t.detach().cpu().numpy() for t in log))


def _vx_rollout(cfg: EnvConfig, params, vx, gen, n_steps, device, delay_steps=0) -> RolloutLog:
    return policy_rollout(_fixed_command_cfg(cfg), params, np.array([vx, 0.0, 0.0]), gen,
                          n_steps, delay_steps=delay_steps, device=device)


def torque_power(cfg: EnvConfig, params, vx, gen: torch.Generator, n_steps=750, skip=100,
                 mass=10.0, device=None):
    """Torque/power traces + TCoT = P/(m g v) (Figure2.py:208-258 metric)."""
    log = _vx_rollout(cfg, params, vx, gen, n_steps, device)
    tau = log.torque.cpu().numpy()[skip:]
    qd = log.gv[:, 6:].cpu().numpy()[skip:]
    power = tau * qd
    total_power = np.abs(power).sum(axis=1)
    vb = np.abs(body_velocity(log)[skip:, 0])
    tcot = float(total_power.mean() / (mass * 9.81 * max(vb.mean(), 1e-6)))
    return {"torque": tau, "joint_vel": qd, "power": power,
            "mean_power": float(total_power.mean()), "tcot": tcot,
            "v_mean": float(vb.mean())}


def work_condition(cfg: EnvConfig, params, vx, gen: torch.Generator, n_steps=750, skip=100,
                   device=None):
    """Motor work-condition points (|qd|, |tau|) + envelope violations
    (run_bp_v5.py:916-1030)."""
    log = _vx_rollout(cfg, params, vx, gen, n_steps, device)
    tau = np.abs(log.torque.cpu().numpy())[skip:]
    qd = np.abs(log.gv[:, 6:].cpu().numpy())[skip:]
    tm, cs, ms = cfg.motor_max_torque, cfg.motor_critical_speed, cfg.motor_max_speed
    ratio = np.array([1.0, 1.0, mdl.KNEE_RATIO] * 4)
    w = qd * ratio
    budget = np.where(w > cs, tm - (w - cs) * tm / (ms - cs), tm) * ratio
    violations = float((tau > budget + 1e-6).mean())
    return {"speed": qd, "torque": tau, "violation_rate": violations}


def state_space(cfg: EnvConfig, params, vx, gen: torch.Generator, n_steps=750, skip=100,
                device=None):
    """(q, qd) phase portraits per joint (run_bp_v5.py:520-662)."""
    log = numpy_log(_vx_rollout(cfg, params, vx, gen, n_steps, device))
    return {"q": log.gc[:, 7:][skip:], "qd": log.gv[:, 6:][skip:], "ref": log.joint_ref[skip:]}


def latency_sweep(cfg: EnvConfig, params, vx, delays_steps, gen: torch.Generator, n_steps=750,
                  skip=200, device=None):
    """Achieved speed vs injected latency (Figure4.py:330-392 experiment)."""
    rows = []
    skip = min(skip, n_steps // 2)   # short smoke runs: keep the window non-empty
    for d in delays_steps:
        log = _vx_rollout(cfg, params, vx, gen, n_steps, device, delay_steps=int(d))
        vb = body_velocity(log)[skip:]
        sign = -1.0 if cfg.wildcat else 1.0
        alive = 1.0 - float(log.done.cpu().numpy()[skip:].mean())
        rows.append({"latency_ms": float(d) * cfg.control_dt * 1e3,
                     "v_mean": float((sign * vb[:, 0]).mean()),
                     "survival": alive})
    return rows


def lstm_state_correlation(cfg: EnvConfig, params, vx, gen: torch.Generator, n_steps=750,
                           skip=100, device=None):
    """Hidden-state correlation heatmap data (run_bp_v5.py:1032-1088)."""
    log = _vx_rollout(cfg, params, vx, gen, n_steps, device)
    h = log.lstm_state.cpu().numpy()[skip:]
    h = h - h.mean(0)
    std = h.std(0) + 1e-8
    return (h / std).T @ (h / std) / h.shape[0]


def value_pca(params, log: RolloutLog, tower: str = "v"):
    """PCA map of LSTM hidden states colored by the value estimate
    (run_bp_v5.py:820-844, the PCA value-function visualization).

    Projects the chosen tower's concatenated hidden states onto their two
    principal components; the color channel is the value head applied to the
    logged value-tower latent (no re-rollout needed)."""
    chs = lstm._split_state(params, log.lstm_state)   # [(c, h)] pi then v
    n_pi = len(params.pi_lstm)
    sel = chs[:n_pi] if tower == "pi" else chs[n_pi:]
    h = np.concatenate([h_.cpu().numpy() for (_, h_) in sel], axis=-1)  # (T, H)
    v_last = chs[-1][1].cpu().numpy()
    value = v_last @ params.vf_w.cpu().numpy()[:, 0] + float(params.vf_b[0])
    hc = h - h.mean(0)
    _, s, vt = np.linalg.svd(hc, full_matrices=False)
    return {"coords": hc @ vt[:2].T, "value": value,
            "explained": (s[:2] ** 2 / max((s ** 2).sum(), 1e-12))}


def spectrogram(signal, dt: float, window: int = 256, hop: int = 32):
    """STFT magnitude of a scalar trace (run_bp_v5.py:1090-1117).

    Hann-windowed, one-sided; returns freqs [Hz], times [s], |S| in dB."""
    x = np.asarray(signal, float)
    if len(x) < window:
        window = max(8, 1 << int(np.log2(max(len(x), 8))))
        hop = max(1, window // 8)
    win = np.hanning(window)
    starts = np.arange(0, len(x) - window + 1, hop)
    frames = np.stack([x[s:s + window] * win for s in starts])
    mag = np.abs(np.fft.rfft(frames, axis=1))
    return {"freqs": np.fft.rfftfreq(window, dt),
            "times": (starts + window / 2) * dt,
            "db": 20 * np.log10(mag.T + 1e-12)}


def toe_trajectories(log: RolloutLog) -> np.ndarray:
    """(T, 4, 3) hip-frame toe positions via FK over the logged joints
    (the end-effector-trajectory mode, run_bp_v5.py:692-736)."""
    return kinematics.legs_fk(log.gc[:, 7:19]).cpu().numpy()


def energy_data(cfg: EnvConfig, params, vx, gen: torch.Generator, n_steps=750, device=None):
    """Per-step energy/dynamics dump (run_bp_v5.py:446-511 --save_energy_data):
    trajectory + applied torques + M^-1 + nonlinearities + mechanical power,
    the arrays the reference exports for Data_Visualization_Code/. M^-1 and
    the nonlinearities are the dense model's (:mod:`..phys.dynamics`) over
    the logged states, all steps in one batch."""
    log = _vx_rollout(cfg, params, vx, gen, n_steps, device)
    p = mdl.nominal_params(cfg, log.gc.device)
    minv = dyn.inverse_mass_matrix(p, log.gc)
    nonlin = dyn.nonlinearities(p, log.gc, log.gv)
    out = numpy_log(log)
    tau, qd = out.torque, out.gv[:, 6:]
    return {"gc": out.gc, "gv": out.gv, "torque": tau, "contact": out.contact,
            "inverse_mass": minv.cpu().numpy(), "nonlinear": nonlin.cpu().numpy(),
            "power": tau * qd}
