"""Training-curve dashboard (TensorboardLauncher replacement).

Port of ``analysis/dashboard.py``, host-side only (numpy and matplotlib).
The reference spawns a TensorBoard daemon against the PPO logger dir
(raisim_gym_helper.py:21-32); here the training loop persists one JSON
object per update (``metrics.jsonl`` via :class:`utils.metrics.JsonlLogger`)
and this module renders the whole run as a static multi-panel curve board
(PNG, or self-contained HTML with the image inlined) — no daemon, works on
an air-gapped box, and the numbers stay machine-readable.

For runs that predate the JSONL logger (or were driven by scripts that only
captured stdout) :func:`parse_train_log` recovers the same rows from the
``update i/n: k=v ...`` lines that :func:`algo.ppo.learn` prints.
:func:`..cli.train.main` renders ``dashboard.png`` into its run dir.

CLI: ``python -m high_speed_quadrupedal_locomotion_by_irrl_torch.analysis.dashboard
<run_dir | metrics.jsonl | train.log> [-o out.png]``
"""

from __future__ import annotations

import base64
import io
import os
import re

import numpy as np

from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.metrics import read_jsonl

_UPDATE_RE = re.compile(r"^update (\d+)(?:/(\d+))?:")
_KV_RE = re.compile(r"([A-Za-z_][\w]*)=([-+]?[\d.]+(?:e[-+]?\d+)?)")

# (panel title, [(key, label)...], log-y)
_PANELS = [
    ("reward", [("reward_per_step", "reward/step")], False),
    ("episodes", [("ep_rew_mean", "ep return"), ("ep_len_mean", "ep length")], False),
    ("losses", [("loss", "total"), ("vf_loss", "value"), ("pg_loss", "policy")], False),
    ("policy entropy", [("entropy", "entropy")], False),
    ("trust region", [("approxkl", "approx KL"), ("clipfrac", "clip frac")], True),
    ("value fit", [("explained_variance", "explained var")], False),
    ("throughput", [("fps", "env steps/s")], False),
]


def parse_train_log(path: str) -> list:
    """Recover per-update metric rows from a captured training stdout."""
    rows = []
    with open(path, errors="replace") as f:
        for line in f:
            m = _UPDATE_RE.match(line.strip())
            if not m:
                continue
            row = {"update": int(m.group(1))}
            for k, v in _KV_RE.findall(line):
                if k != "update":
                    row[k] = float(v)
            rows.append(row)
    return rows


def load_metrics(path: str) -> list:
    """Accept a run dir (metrics.jsonl inside), a .jsonl file, or a log."""
    if os.path.isdir(path):
        jl = os.path.join(path, "metrics.jsonl")
        if os.path.exists(jl):
            return read_jsonl(jl)
        raise FileNotFoundError(f"no metrics.jsonl in {path}")
    if path.endswith(".jsonl"):
        return read_jsonl(path)
    return parse_train_log(path)


def _x_axis(rows):
    if rows and "timesteps" in rows[0]:
        return np.array([r.get("timesteps", np.nan) for r in rows]), "env steps"
    return np.arange(1, len(rows) + 1), "update"


def training_dashboard(rows: list, path: str, title: str = "") -> str:
    """Render the curve board; returns the output path.

    ``ep_rew_mean``/``ep_len_mean`` are masked where no episode ended that
    update (``ep_count == 0``) instead of plotting the 0 placeholders.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not rows:
        raise ValueError("no metric rows to plot")
    x, xlab = _x_axis(rows)
    panels = [(t, ks, ly) for (t, ks, ly) in _PANELS
              if any(k in rows[0] for k, _ in ks)]
    ncol = 2
    nrow = (len(panels) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(11, 2.8 * nrow), squeeze=False)
    for ax, (ptitle, keys, logy) in zip(axes.ravel(), panels):
        for k, label in keys:
            if k not in rows[0]:
                continue
            y = np.array([r.get(k, np.nan) for r in rows], float)
            if k.startswith("ep_") and "ep_count" in rows[0]:
                cnt = np.array([r.get("ep_count", 1) for r in rows], float)
                y = np.where(cnt > 0, y, np.nan)
            ax.plot(x, y, lw=1, label=label)
        if logy:
            ax.set_yscale("log")
        ax.set_title(ptitle, fontsize=10)
        ax.set_xlabel(xlab, fontsize=8)
        ax.tick_params(labelsize=8)
        if len(keys) > 1:
            ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
    for ax in axes.ravel()[len(panels):]:
        ax.axis("off")
    if title:
        fig.suptitle(title, fontsize=12)
    fig.tight_layout()

    if path.endswith(".html"):
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=140)
        b64 = base64.b64encode(buf.getvalue()).decode()
        with open(path, "w") as f:
            f.write("<!doctype html><html><head><meta charset='utf-8'>"
                    f"<title>{title or 'training dashboard'}</title></head>"
                    "<body style='background:#111;text-align:center'>"
                    f"<img style='max-width:100%' src='data:image/png;base64,{b64}'>"
                    "</body></html>")
    else:
        fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="render training-curve dashboard")
    p.add_argument("source", help="run dir, metrics.jsonl, or captured train log")
    p.add_argument("-o", "--out", default=None,
                   help="output .png/.html (default: <source>/dashboard.png)")
    args = p.parse_args(argv)
    out = args.out or (os.path.join(args.source, "dashboard.png")
                       if os.path.isdir(args.source) else
                       os.path.splitext(args.source)[0] + "_dashboard.png")
    rows = load_metrics(args.source)
    training_dashboard(rows, out, title=os.path.basename(args.source.rstrip("/")))
    print(f"{out}: {len(rows)} updates")
    return out


if __name__ == "__main__":
    main()
