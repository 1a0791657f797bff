"""Evaluation entry point of the PyTorch port (run_bp_v5.py test branch).

  python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.test \
      --model artifacts/irrl_tpu_relaxed_4e8 --eval --commands 1,2,3,4,5 --steps 2000

  python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.test \
      --cfg high_speed_quadrupedal_locomotion_by_irrl_torch/configs/bp5_relax_terrain.yaml \
      --model artifacts/irrl_tpu_terrain_relaxed_r5 --eval --commands 1,2,3 --steps 1500

Port of the ``--eval`` mode of the JAX package's ``cli/test.py``: velocity
tracking of a controller (a bp5 CSV directory, or a ``ckpt_*.pkl`` that the
port's ``cli.train`` wrote), all commands rolled as one batch on the card
(``--device cuda``, the default) or on the CPU (``--device cpu``). On a
terrain config every command starts on the same stretch of the heightmap,
drawn from the config's seed. Prints one ``cmd ... -> v ...`` line per
command.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio


def parse_args(argv):
    p = argparse.ArgumentParser(description="IRRL evaluation (PyTorch port)")
    p.add_argument("--model", type=str, required=True,
                   help="bp5 CSV directory or checkpoint .pkl of this port")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--commands", type=str, default="1,2,3,4,5")
    p.add_argument("--steps", type=int, default=750)
    p.add_argument("--eval", action="store_true", help="velocity tracking eval")
    p.add_argument("--material", type=str, default=None, metavar="F,E,T",
                   help="contact material triple friction,restitution,threshold "
                        "(SetContactCoefficient, Environment.hpp:1407-1418)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = dev_mod.resolve(args.device)
    cfg = cfg_mod.from_yaml(args.cfg) if args.cfg else cfg_mod.test_default()
    if args.material is not None:
        f, e, t = (float(x) for x in args.material.split(","))
        cfg = cfg.replace(contact_friction=f, contact_restitution=e,
                          contact_res_threshold=t)
    else:
        print("cli.test: no --material given; running on the config's "
              f"default contact triple ({cfg.contact_friction}, "
              f"{cfg.contact_restitution}, {cfg.contact_res_threshold}). "
              "For reference test-path parity pass "
              "--material 0.8,0.2,0.01 (run_bp_v5.py:317)")
    if os.path.isdir(args.model):
        params = mio.load_bp5_csv(args.model, device=device)
    else:
        params, _, _ = mio.load_checkpoint(args.model, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    results = {}
    if args.eval:
        cmds = [float(c) for c in args.commands.split(",")]
        results["tracking"] = ev.tracking_eval(cfg, params, cmds, gen, args.steps,
                                               device=device)
        for r in results["tracking"]:
            print(f"cmd {r['command']:.1f} m/s -> v {r['v_mean']:+.2f} "
                  f"(err {r['err_mean']:+.3f} +- {r['err_std']:.3f})")
    return results


if __name__ == "__main__":
    main()
