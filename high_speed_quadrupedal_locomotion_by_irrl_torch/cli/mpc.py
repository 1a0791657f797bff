"""Closed-loop MPC entry point of the PyTorch port.

    python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.mpc \
        --engine srb --commands 1,2,3,4,5 --steps 2500

Port of the JAX package's ``cli/mpc.py`` for the convex SRB trot-MPC: each
command runs its speed-scheduled configuration (``mpc/runtime.speed_schedule``)
in closed loop, on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``). Commands that share a schedule roll as one batch of envs.
Prints the steady-state body velocity (trailing 40 % of the rollout), the fall
count and the mean solve cost of the last 100 steps per command; ``--dump-info``
writes the last command's rollout as the reference's info CSV. The whole-body
engine (``--engine wb``) and the viewer export raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import rawdata
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl


def parse_args(argv):
    p = argparse.ArgumentParser(description="closed-loop MPC control in the BlackPanther "
                                "env (PyTorch port: SRB trot-MPC)")
    p.add_argument("--engine", choices=("srb", "wb"), default="srb")
    p.add_argument("--vx", type=float, default=None, help="single forward-velocity command [m/s]")
    p.add_argument("--commands", type=str, default=None,
                   help="comma-separated commands for a tracking table")
    p.add_argument("--steps", type=int, default=2500, help="control steps per rollout (500 Hz)")
    p.add_argument("--cfg", type=str, default=None,
                   help="reference-format YAML (default: test config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--viewer", type=str, default=None, metavar="OUT.html",
                   help="interactive 3D playback (not in the port yet)")
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


def schedule_batches(cfg, cmds) -> dict:
    """{(env_cfg, SRBConfig, mpc_rollout kwargs): [vx, ...]}: the commands that
    share one speed schedule, which roll as one batch, in order of first
    appearance."""
    groups: dict = {}
    for vx in cmds:
        env_cfg, scfg, kwargs = runtime.speed_schedule(cfg, vx)
        groups.setdefault((env_cfg, scfg, tuple(kwargs.items())), []).append(vx)
    return groups


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.engine == "wb":
        raise NotImplementedError("--engine wb is not in the PyTorch port yet (ROADMAP.md, "
                                  "Queue 1: whole-body iLQR)")
    if args.viewer:
        raise NotImplementedError("--viewer is not in the PyTorch port yet (ROADMAP.md, "
                                  "Queue 1: analysis and tooling, analysis/viewer.py)")
    device = dev_mod.resolve(args.device)
    cfg = cfg_mod.from_yaml(args.cfg) if args.cfg else cfg_mod.test_default()
    if args.commands:
        cmds = [float(c) for c in args.commands.split(",")]
    else:
        cmds = [args.vx if args.vx is not None else 1.0]

    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(f"engine={args.engine} steps={args.steps} (500 Hz control)")
    rows, last = {}, None
    for (env_cfg, scfg, kwargs), vxs in schedule_batches(cfg, cmds).items():
        batch = np.array([[vx, 0.0, 0.0] for vx in vxs], np.float32)
        log = runtime.mpc_rollout(env_cfg, scfg, batch, gen, args.steps, device=device,
                                  **dict(kwargs))
        vb = ev.body_velocity(log)[int(args.steps * 0.6):]          # (T', B, 3)
        falls = log.done.sum(dim=0).cpu().numpy()
        cost = log.solve_cost[-100:].mean(dim=0).cpu().numpy()
        for b, vx in enumerate(vxs):
            rows[vx] = {"command": vx, "v_mean": float(vb[:, b, 0].mean()),
                        "falls": int(falls[b]), "solve_cost": float(cost[b]),
                        "period": env_cfg.period, "lam": env_cfg.lam}
            last = (log, b) if vx == cmds[-1] else last
    results = {"rows": [rows[vx] for vx in dict.fromkeys(cmds)]}
    for r in results["rows"]:
        print(f"  cmd {r['command']:4.1f} m/s -> v {r['v_mean']:+5.2f} m/s  falls {r['falls']}  "
              f"solve cost ~{r['solve_cost']:.2f}  (T={r['period']:.2f}s "
              f"lam={r['lam']:.2f})", flush=True)

    if args.dump_info:
        log, b = last
        gc = log.gc[:, b]
        rawdata.dump_robot_info(args.dump_info, gc.cpu().numpy(), log.gv[:, b].cpu().numpy(),
                                log.torque[:, b].cpu().numpy(), toe_contact(gc).cpu().numpy())
        print(f"robot-info CSV: {args.dump_info}")
        results["dump_info"] = args.dump_info
    return results


if __name__ == "__main__":
    main()
