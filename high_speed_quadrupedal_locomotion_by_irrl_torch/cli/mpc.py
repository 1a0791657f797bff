"""Closed-loop MPC entry point of the PyTorch port.

    python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.mpc \
        --engine srb --commands 1,2,3,4,5 --steps 2500
    python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.mpc \
        --engine wb --commands 1,2,3,4,5 --steps 2500

Port of the JAX package's ``cli/mpc.py``: each command runs its
speed-scheduled configuration in closed loop, the convex SRB trot-MPC
(``--engine srb``, ``mpc/runtime.speed_schedule``) or the whole-body
receding-horizon iLQR (``--engine wb``, ``mpc/runtime.wb_speed_schedule``;
rollouts beyond 1200 steps through ``wb_mpc_rollout_chunked`` in 500-step
segments, as the JAX CLI), on the card (``--device cuda``, the default) or on
the CPU (``--device cpu``). Commands that share a schedule roll as one batch
of envs. Prints the steady-state body velocity (trailing 40 % of the
rollout), the fall count and the mean solve cost of the last 100 steps per
command; ``--dump-info`` writes the last command's rollout as the reference's
info CSV (the whole-body log has no torque: written as zeros, as the JAX CLI
does); ``--viewer`` writes the same rollout as the self-contained HTML viewer
of :mod:`..analysis.viewer`.
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import rawdata, viewer
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl


def parse_args(argv):
    p = argparse.ArgumentParser(description="closed-loop MPC control in the BlackPanther "
                                "env (PyTorch port: SRB trot-MPC or whole-body iLQR)")
    p.add_argument("--engine", choices=("srb", "wb"), default="srb")
    p.add_argument("--vx", type=float, default=None, help="single forward-velocity command [m/s]")
    p.add_argument("--commands", type=str, default=None,
                   help="comma-separated commands for a tracking table")
    p.add_argument("--steps", type=int, default=2500, help="control steps per rollout (500 Hz)")
    p.add_argument("--cfg", type=str, default=None,
                   help="reference-format YAML (default: test config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--viewer", type=str, default=None, metavar="OUT.html",
                   help="write the last command's rollout as an interactive 3D viewer")
    p.add_argument("--dump-info", type=str, default=None, metavar="OUT.csv",
                   help="export the last command's rollout in the reference's info CSV format")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def toe_contact(gc: torch.Tensor) -> torch.Tensor:
    """(T, 19) -> (T, 4) contact flags from toe height (the MPC logs carry none)."""
    P = lanes.params_to_lanes(mdl.nominal_params(None, gc.device).expand(gc.shape[0]))
    toe = lanes.fk_lanes(P, list(gc.T))
    z = torch.stack([foot[2] for foot in toe.toe], dim=-1)
    return (z < mdl.TOE_RADIUS + 1e-3).to(gc.dtype)


def schedule_batches(cfg, cmds, engine: str = "srb") -> dict:
    """{schedule: [vx, ...]}: the commands that share one speed schedule, which
    roll as one batch, in order of first appearance. A schedule is
    (env_cfg, SRBConfig, mpc_rollout kwargs) for the SRB engine and
    (env_cfg, MPCConfig) for the whole-body one."""
    groups: dict = {}
    for vx in cmds:
        if engine == "srb":
            env_cfg, scfg, kwargs = runtime.speed_schedule(cfg, vx)
            key = (env_cfg, scfg, tuple(kwargs.items()))
        else:
            key = runtime.wb_speed_schedule(cfg, vx)
        groups.setdefault(key, []).append(vx)
    return groups


def _rollout(engine: str, schedule, batch: np.ndarray, gen, n_steps: int, device):
    """The rollout of one schedule batch: a log of (T, B, ...) fields."""
    if engine == "srb":
        env_cfg, scfg, kwargs = schedule
        return runtime.mpc_rollout(env_cfg, scfg, batch, gen, n_steps, device=device,
                                   **dict(kwargs))
    env_cfg, mpc_cfg = schedule
    if n_steps > 1200:   # the JAX CLI's crash-safe harness for long rollouts, physics unchanged
        log = runtime.wb_mpc_rollout_chunked(env_cfg, mpc_cfg, batch, gen, n_steps, chunk=500,
                                             device=device)
        return runtime.WBMPCRolloutLog(*(torch.from_numpy(x) for x in log))
    return runtime.wb_mpc_rollout(env_cfg, mpc_cfg, batch, gen, n_steps, device=device)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = dev_mod.resolve(args.device)
    cfg = cfg_mod.from_yaml(args.cfg) if args.cfg else cfg_mod.test_default()
    if args.commands:
        cmds = [float(c) for c in args.commands.split(",")]
    else:
        cmds = [args.vx if args.vx is not None else 1.0]

    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(f"engine={args.engine} steps={args.steps} (500 Hz control)")
    rows, last = {}, None
    for schedule, vxs in schedule_batches(cfg, cmds, args.engine).items():
        env_cfg = schedule[0]
        batch = np.array([[vx, 0.0, 0.0] for vx in vxs], np.float32)
        log = _rollout(args.engine, schedule, batch, gen, args.steps, device)
        vb = ev.body_velocity(log)[int(args.steps * 0.6):]          # (T', B, 3)
        falls = log.done.sum(dim=0).cpu().numpy()
        cost = log.solve_cost[-100:].mean(dim=0).cpu().numpy()
        for b, vx in enumerate(vxs):
            rows[vx] = {"command": vx, "v_mean": float(vb[:, b, 0].mean()),
                        "falls": int(falls[b]), "solve_cost": float(cost[b]),
                        "period": env_cfg.period, "lam": env_cfg.lam}
            last = (env_cfg, log, b) if vx == cmds[-1] else last
    results = {"rows": [rows[vx] for vx in dict.fromkeys(cmds)]}
    for r in results["rows"]:
        print(f"  cmd {r['command']:4.1f} m/s -> v {r['v_mean']:+5.2f} m/s  falls {r['falls']}  "
              f"solve cost ~{r['solve_cost']:.2f}  (T={r['period']:.2f}s "
              f"lam={r['lam']:.2f})", flush=True)

    if args.viewer:
        env_cfg, log, b = last
        one = SimpleNamespace(**{f: getattr(log, f)[:, b].cpu().numpy() for f in log._fields})
        print(f"viewer: {viewer.write_html(env_cfg, one, args.viewer)}")
        results["viewer"] = args.viewer
    if args.dump_info:
        _, log, b = last
        gc = log.gc[:, b]
        tau = log.torque[:, b] if hasattr(log, "torque") else torch.zeros_like(gc[:, 7:])
        rawdata.dump_robot_info(args.dump_info, gc.cpu().numpy(), log.gv[:, b].cpu().numpy(),
                                tau.cpu().numpy(), toe_contact(gc).cpu().numpy())
        print(f"robot-info CSV: {args.dump_info}")
        results["dump_info"] = args.dump_info
    return results


if __name__ == "__main__":
    main()
