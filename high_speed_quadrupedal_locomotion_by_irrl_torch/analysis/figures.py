"""Paper-figure pipelines (Data_Visualization_Code parity) + gait diagrams.

Port of ``analysis/figures.py``: every function takes numpy arrays (a
``RolloutLog`` as :func:`..analysis.eval.numpy_log` gives it), and renders on
the host. Matplotlib is imported lazily with the Agg backend so headless
boxes can render. Covered capabilities:

- :func:`velocity_tracking_figure` — command vs achieved v_x panels
  (Figure2.py:267-291)
- :func:`tcot_figure`              — total-cost-of-transport bars across
  command speeds (Figure2.py:208-258)
- :func:`work_condition_figure`    — motor (speed, torque) scatter with the
  derating envelope (run_bp_v5.py:916-1030 / Figure5)
- :func:`latency_figure`           — speed vs injected latency (Figure4.py:330-392)
- :func:`gait_bar`                 — phase-colored stance/swing diagram
  (utils/GaitColorBar.py:11-131)
- :func:`rollout_animation`        — stick-figure side-view animation of a
  rollout (the headless stand-in for the OgreVis video recorder,
  RaisimGymEnv.hpp:88-94)
"""

from __future__ import annotations

import numpy as np


def _body_velocity(log) -> np.ndarray:
    """(T, 3) body-frame linear velocity of a numpy log."""
    from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis.rawdata import (
        _quat_to_matrix_np,
    )
    R = _quat_to_matrix_np(np.asarray(log.gc)[:, 3:7])
    return np.einsum("tji,tj->ti", R, np.asarray(log.gv)[:, :3])


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def velocity_tracking_figure(rows, path: str):
    plt = _mpl()
    cmds = [r["command"] for r in rows]
    vs = [r["v_mean"] for r in rows]
    errs = [r["err_std"] for r in rows]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.errorbar(cmds, vs, yerr=errs, marker="o", capsize=3, label="achieved")
    ax.plot(cmds, cmds, "k--", lw=1, label="command")
    ax.set_xlabel("command $v_x$ [m/s]"); ax.set_ylabel("achieved $v_x^B$ [m/s]")
    ax.legend(); fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def tcot_figure(results, path: str, mass: float = 10.0):
    """results: list of dicts from analysis.eval.torque_power per command."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 4))
    vs = [r["v_mean"] for r in results]
    tcots = [r["tcot"] for r in results]
    ax.bar(range(len(vs)), tcots, tick_label=[f"{v:.1f}" for v in vs])
    ax.set_xlabel("achieved speed [m/s]"); ax.set_ylabel("TCoT = P/(m g v)")
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def work_condition_figure(wc, cfg, path: str):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(wc["speed"].ravel(), wc["torque"].ravel(), s=2, alpha=0.2)
    tm, cs, ms = cfg.motor_max_torque, cfg.motor_critical_speed, cfg.motor_max_speed
    w = np.linspace(0, ms, 100)
    env = np.where(w > cs, tm - (w - cs) * tm / (ms - cs), tm)
    ax.plot(w, env, "r-", lw=2, label="motor envelope")
    ax.set_xlabel("|joint speed| [rad/s]"); ax.set_ylabel("|torque| [Nm]")
    ax.legend(); fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def recorded_velocity_figure(vel_body, dt: float, path: str,
                             v_cmd: float | None = None,
                             title: str = ""):
    """Body-frame velocity trace of a recorded run (Figure3-style panel over
    a RobotBodyInfo stream). vel_body: (T, 3) from RobotBodyInfo.vel_body."""
    plt = _mpl()
    v = np.asarray(vel_body)
    t = np.arange(v.shape[0]) * dt
    fig, ax = plt.subplots(figsize=(7, 3.2))
    ax.plot(t, v[:, 0], lw=0.7, label="$v_x^B$")
    ax.plot(t, v[:, 1], lw=0.7, alpha=0.6, label="$v_y^B$")
    if v_cmd is not None:
        ax.axhline(v_cmd, color="k", ls="--", lw=1, label="command")
    # steady-state mean over the back half (the parity anchor statistic)
    half = v.shape[0] // 2
    m = float(v[half:, 0].mean())
    ax.axhline(m, color="C3", ls=":", lw=1,
               label=f"steady mean {m:.2f} m/s")
    ax.set_xlabel("t [s]"); ax.set_ylabel("body velocity [m/s]")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=8, ncol=4)
    fig.tight_layout(); fig.savefig(path, dpi=130); plt.close(fig)


def latency_figure(rows, path: str, title: str = ""):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.errorbar([r["latency_ms"] for r in rows], [r["v_mean"] for r in rows],
                yerr=[r.get("v_err", 0.0) for r in rows], marker="o",
                capsize=3)
    ax.set_xlabel("control latency [ms]"); ax.set_ylabel("achieved $v_x^B$ [m/s]")
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def tracking_panels_figure(logs_by_cmd, dt: float, path: str, sign: float = 1.0):
    """Time-series tracking panels (Figure2.py:267-291): v_x^B(t) traces per
    commanded speed with the command as dashed steps, plus body height.

    logs_by_cmd: {command: RolloutLog}."""
    plt = _mpl()

    fig, axes = plt.subplots(2, 1, figsize=(7, 5), sharex=True,
                             height_ratios=[2, 1])
    cmap = plt.get_cmap("viridis")
    cmds = sorted(logs_by_cmd)
    for i, c in enumerate(cmds):
        log = logs_by_cmd[c]
        t = np.arange(len(np.asarray(log.gc))) * dt
        vb = sign * _body_velocity(log)[:, 0]
        col = cmap(i / max(len(cmds) - 1, 1))
        axes[0].plot(t, vb, color=col, lw=1, label=f"cmd {c:g} m/s")
        axes[0].axhline(c, color=col, ls="--", lw=0.8)
        axes[1].plot(t, np.asarray(log.gc)[:, 2], color=col, lw=1)
    axes[0].set_ylabel("$v_x^B$ [m/s]"); axes[0].legend(fontsize=7, ncol=2)
    axes[1].set_ylabel("body height [m]"); axes[1].set_xlabel("time [s]")
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def kappa_latency_figure(rows, path: str, entropy_curves=None):
    """Figure4.py:364-390 twin-axis panel: recovery rate kappa (left, C0)
    and achieved forward speed (right, C3) vs control latency.

    rows: dicts with latency_ms, kappa, kappa_err (optional), v_mean,
    v_err (optional). entropy_curves: optional {label: (t, entropy, fit_y)}
    inset data appended as a second panel showing the raw entropy decays."""
    plt = _mpl()
    ncols = 2 if entropy_curves else 1
    fig, axs = plt.subplots(1, ncols, figsize=(5 * ncols, 4))
    ax = axs[0] if entropy_curves else axs
    lat = [r["latency_ms"] for r in rows]
    ax.errorbar(lat, [r["kappa"] for r in rows],
                yerr=[3 * r.get("kappa_err", 0.0) for r in rows],
                marker="o", capsize=4, lw=2, color="C0")
    ax.set_xlabel("Latency (ms)")
    ax.set_ylabel(r"$\kappa\ (\log_e/\mathrm{s})$", color="C0")
    ax.tick_params(axis="y", labelcolor="C0")
    ax.axhline(0.0, color="k", lw=0.5, ls=":")
    ax2 = ax.twinx()
    ax2.errorbar(lat, [r["v_mean"] for r in rows],
                 yerr=[3 * r.get("v_err", 0.0) for r in rows],
                 marker="s", capsize=4, lw=2, color="C3", alpha=0.8)
    ax2.set_ylabel(r"$v_x^B$ (m/s)", color="C3")
    ax2.tick_params(axis="y", labelcolor="C3")
    if entropy_curves:
        for label, (t, ent, fit_y) in entropy_curves.items():
            axs[1].plot(t, ent, lw=0.8, alpha=0.6)
            axs[1].plot(t, fit_y, lw=1.5, ls="--", label=label)
        axs[1].set_xlabel("t [s]"); axs[1].set_ylabel("ensemble entropy [nats]")
        axs[1].legend(fontsize=7)
    fig.tight_layout(); fig.savefig(path, dpi=140); plt.close(fig)


def poincare_figure(series_by_label, path: str, lag_steps: int = 1,
                    xlabel: str = "$x_n$", ylabel: str = "$x_{n+1}$"):
    """Figure4 plot_poincare: first-return maps x_n vs x_{n+lag} per series
    (limit-cycle convergence indicator). series_by_label: {label: (T,) array}."""
    plt = _mpl()
    n = len(series_by_label)
    fig, axes = plt.subplots(1, n, figsize=(2.6 * n, 2.8), squeeze=False)
    for ax, (label, x) in zip(axes[0], series_by_label.items()):
        x = np.asarray(x)
        lo, hi = float(x.min()), float(x.max())
        pad = 0.08 * max(hi - lo, 1e-6)
        ax.plot([lo - pad, hi + pad], [lo - pad, hi + pad], color="C0", lw=0.5)
        ax.scatter(x[:-lag_steps], x[lag_steps:], marker="x", s=6,
                   color="C1", alpha=0.5, linewidth=0.5)
        ax.set_xlim(lo - pad, hi + pad); ax.set_ylim(lo - pad, hi + pad)
        ax.set_title(label, fontsize=8)
        ax.set_xlabel(xlabel, fontsize=7); ax.set_ylabel(ylabel, fontsize=7)
        ax.tick_params(labelsize=6)
    fig.tight_layout(); fig.savefig(path, dpi=140); plt.close(fig)


def tcot_grouped_figure(results_by_controller, path: str):
    """Grouped TCoT bars across controllers (the Theta^f/Theta^m/Theta^v
    comparison of Figure2.py:208-258).

    results_by_controller: {name: list of analysis.eval.torque_power dicts}."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    names = list(results_by_controller)
    n_cmd = max(len(v) for v in results_by_controller.values())
    width = 0.8 / max(len(names), 1)
    for i, name in enumerate(names):
        res = results_by_controller[name]
        xs = np.arange(len(res)) + i * width
        ax.bar(xs, [r["tcot"] for r in res], width=width, label=name)
    ax.set_xticks(np.arange(n_cmd) + 0.4 - width / 2)
    ax.set_xticklabels([f"{i + 1}" for i in range(n_cmd)])
    ax.set_xlabel("command $v_x$ [m/s]"); ax.set_ylabel("TCoT = P/(m g v)")
    ax.legend(); fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def recovery_figure(rows, path: str):
    """Speed and recovery-rate kappa vs control latency (Figure4.py:330-392):
    the reference's headline robustness curve, from
    analysis.robustness.latency_recovery rows."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5.5, 4))
    lat = [r["latency_ms"] for r in rows]
    ax.plot(lat, [r["v_mean"] for r in rows], "o-", color="C0",
            label="$v_x^B$")
    ax.set_xlabel("control latency [ms]")
    ax.set_ylabel("achieved $v_x^B$ [m/s]", color="C0")
    ax2 = ax.twinx()
    ax2.plot(lat, [r["kappa"] for r in rows], "s--", color="C3",
             label=r"$\kappa$")
    ax2.set_ylabel(r"recovery rate $\kappa$ [log$_e$/s]", color="C3")
    ax2.set_ylim(-10, 2)   # the reference's axis range (Figure4.py:386-390)
    for r, x in zip(rows, lat):
        if not r.get("survived", True):
            ax.axvspan(x - 0.2, x + 0.2, color="red", alpha=0.15)
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def _ternary_xy(w: np.ndarray):
    """Barycentric (N,3) -> 2-d coords (equilateral triangle)."""
    x = w[:, 1] + 0.5 * w[:, 2]
    y = np.sqrt(3) / 2 * w[:, 2]
    return x, y


def ternary_landscape_figure(res, comps, path: str, normalized: bool = True):
    """The five ternary reward-landscape panels (Figure2.py:362-460) from
    analysis.landscape results — rendered with plain matplotlib
    tricontourf on barycentric-projected coordinates (no mpltern needed).

    res: dict from landscape.reward_landscape; comps: landscape.composites."""
    plt = _mpl()
    names = [r"$r^f$", r"$r^v$", r"$r^m$", r"$r^b$", r"$r^t$"]
    keys = ["r_f", "r_v", "r_m", "r_b", "r_t"]
    x, y = _ternary_xy(res["w"])
    fig, axes = plt.subplots(1, 5, figsize=(16, 3.2))
    for ax, name, k in zip(axes, names, keys):
        z = np.asarray(comps[k], dtype=float)
        if normalized:
            z = (z - z.min()) / max(z.max() - z.min(), 1e-12)
        tc = ax.tricontourf(x, y, z, levels=50, cmap="magma")
        ax.plot([0, 1, 0.5, 0], [0, 0, np.sqrt(3) / 2, 0], "k-", lw=0.8)
        ax.set_title(name, y=1.12)  # above the Theta_2 vertex label
        ax.set_aspect("equal"); ax.axis("off")
        # vertex labels: w0 (left), w1 (right), w2 (top)
        ax.text(-0.05, -0.06, r"$\Theta_0$", ha="center", fontsize=8)
        ax.text(1.05, -0.06, r"$\Theta_1$", ha="center", fontsize=8)
        ax.text(0.5, np.sqrt(3) / 2 + 0.04, r"$\Theta_2$", ha="center", fontsize=8)
    fig.colorbar(tc, ax=axes, shrink=0.8, label="normalized reward")
    fig.savefig(path, dpi=150, bbox_inches="tight"); plt.close(fig)


def gait_bar(cfg, path: str, n_phase: int = 200):
    """Phase-colored stance(dark)/swing(light) bars per leg (GaitColorBar parity)."""
    plt = _mpl()
    phases = np.asarray(cfg.phase_offsets)
    t = np.linspace(0, 1, n_phase)
    fig, ax = plt.subplots(figsize=(6, 2))
    names = ["FR", "FL", "HR", "HL"]
    for i, (ph, name) in enumerate(zip(phases, names)):
        real = np.mod(t + ph, 1.0)
        stance = real < cfg.lam
        ax.scatter(t, np.full_like(t, 3 - i), c=np.where(stance, 0.1, 0.8),
                   cmap="Greys_r", vmin=0, vmax=1, marker="s", s=14)
    ax.set_yticks(range(4), names[::-1]); ax.set_xlabel("gait phase")
    ax.set_title(f"gait {['trot','bound','gallop'][cfg.gait_type]}, duty {cfg.lam}")
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def rollout_animation(log, path: str, stride: int = 10):
    """Side-view stick-figure animation from a RolloutLog (gif/mp4 by suffix)."""
    plt = _mpl()
    import torch
    from matplotlib import animation

    from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
    from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl

    gcs = np.asarray(log.gc)[::stride]
    params = mdl.nominal_params(device="cpu")
    kins = dyn.fk(params, torch.as_tensor(gcs, dtype=torch.float32))
    p = kins.p.numpy()          # (F, 13, 3)
    toes = kins.toe_pos.numpy()  # (F, 4, 3)

    fig, ax = plt.subplots(figsize=(6, 3))
    lines = [ax.plot([], [], "o-", lw=2)[0] for _ in range(4)]
    body_line, = ax.plot([], [], "k-", lw=3)
    ax.axhline(0, color="gray", lw=1)
    ax.set_ylim(-0.05, 0.7); ax.set_aspect("equal")

    chains = [(0, 1, 2, 3), (0, 4, 5, 6), (0, 7, 8, 9), (0, 10, 11, 12)]

    def draw(f):
        x0 = p[f, 0, 0]
        ax.set_xlim(x0 - 0.6, x0 + 0.6)
        for li, ch in zip(lines, chains):
            xs = list(p[f, ch, 0]) + [toes[f, chains.index(ch), 0]]
            zs = list(p[f, ch, 2]) + [toes[f, chains.index(ch), 2]]
            li.set_data(xs, zs)
        body_line.set_data([p[f, 1, 0], p[f, 10, 0]], [p[f, 1, 2], p[f, 10, 2]])
        return lines + [body_line]

    anim = animation.FuncAnimation(fig, draw, frames=len(gcs), blit=True)
    anim.save(path, fps=20, writer="pillow" if path.endswith(".gif") else None)
    plt.close(fig)


def pca_value_figure(res, path: str):
    """Hidden-state PCA scatter colored by value (run_bp_v5.py:820-844)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 4))
    sc = ax.scatter(res["coords"][:, 0], res["coords"][:, 1], c=res["value"],
                    s=4, cmap="viridis")
    fig.colorbar(sc, ax=ax, label="V(s)")
    e = res["explained"]
    ax.set_xlabel(f"PC1 ({e[0]:.0%})"); ax.set_ylabel(f"PC2 ({e[1]:.0%})")
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


def spectrogram_figure(spec, path: str, fmax: float = 50.0):
    """STFT magnitude heatmap (run_bp_v5.py:1090-1117)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    keep = spec["freqs"] <= fmax
    pc = ax.pcolormesh(spec["times"], spec["freqs"][keep], spec["db"][keep],
                       shading="auto", cmap="magma")
    fig.colorbar(pc, ax=ax, label="|S| [dB]")
    ax.set_xlabel("time [s]"); ax.set_ylabel("freq [Hz]")
    fig.tight_layout(); fig.savefig(path, dpi=150); plt.close(fig)


_JOINT_NAMES = [f"{leg}_{j}" for leg in ("FR", "FL", "HR", "HL")
                for j in ("abad", "hip", "knee")]


def joint_traces_figure(log, dt: float, path: str):
    """12-panel joint angle vs reference traces (run_bp_v5.py:664-690)."""
    plt = _mpl()
    q = np.asarray(log.gc[:, 7:19]); qr = np.asarray(log.joint_ref)
    t = np.arange(len(q)) * dt
    fig, axes = plt.subplots(4, 3, figsize=(10, 9), sharex=True)
    for i, ax in enumerate(axes.ravel()):
        ax.plot(t, q[:, i], lw=0.8, label="q")
        ax.plot(t, qr[:, i], lw=0.8, ls="--", label="ref")
        ax.set_title(_JOINT_NAMES[i], fontsize=9)
        ax.tick_params(labelsize=7)
    axes[0, 0].legend(fontsize=7)
    for ax in axes[-1]:
        ax.set_xlabel("t [s]", fontsize=8)
    fig.tight_layout(); fig.savefig(path, dpi=130); plt.close(fig)


def ee_traj_figure(toe_xyz, path: str, skip: int = 100):
    """Side-view (x-z) hip-frame toe loops per leg (run_bp_v5.py:692-736)."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 4, figsize=(12, 3), sharey=True)
    for i, (ax, name) in enumerate(zip(axes, ("FR", "FL", "HR", "HL"))):
        ax.plot(toe_xyz[skip:, i, 0], toe_xyz[skip:, i, 2], lw=0.5)
        ax.set_title(name, fontsize=9); ax.set_xlabel("x [m]")
        ax.set_aspect("equal")
    axes[0].set_ylabel("z [m]")
    fig.tight_layout(); fig.savefig(path, dpi=140); plt.close(fig)
