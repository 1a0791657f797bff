"""Training / relaxation entry point of the PyTorch port.

CLI parity with the reference's train branch (run_bp_v5.py:209-259):

  imitation:  python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.train \
                  --cfg high_speed_quadrupedal_locomotion_by_irrl_torch/configs/bp5_imitation.yaml \
                  --lr 1e-3 --max-iter 200000000
  relaxation: ... --cfg .../configs/bp5_train.yaml --load runs/<stamp>/ckpt_final.pkl --lr 5e-4
              (the relaxed reward coefficients are in the YAML, readme.md:64-75)

Runs on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``). Checkpoints include Adam's state (unlike PPO2.save,
ppo2.py:452-476) and come with a bp5-format CSV export for the
dependency-free deployment path; ``--load`` takes either. At the end the
run's curves are rendered into ``dashboard.png`` (:mod:`..analysis.dashboard`;
skipped with a message if that fails, as in the JAX package). The JAX package's
``.pkl`` checkpoints are not read: hand such a controller over as its CSV
directory. The physics follows the JAX package's rule: the batch-in-lanes
``step_batch`` at ``--num-envs`` >= 1024 or with ``--lanes``, else the per-env
``step`` (every shipped training YAML has 200 envs), which ``--no-lanes``
forces at any width and which alone runs ``HardContact`` and ``Crutial``.

  rough terrain: ... --cfg .../configs/bp5_relax_terrain.yaml \
                     --load artifacts/irrl_tpu_terrain_relaxed --num-envs 1024 \
                     --lr 1e-4 --lr-final 2e-5 --entropy-floor 5.2 \
                     --terrain-z-curriculum 0.05,0.1

  multi-GPU:  python -m torch.distributed.run --standalone --nproc-per-node 4 \
                  -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.train --distributed \
                  --cfg .../configs/bp5_train.yaml --num-envs 4096 ...

``--distributed`` is the JAX package's data parallelism over
``torch.distributed`` (:mod:`..parallel`): each rank steps its block of
``--num-envs`` (which must split evenly), the policy is replicated and the
gradients and metrics are summed over the ranks, so W ranks compute what one
does. Under ``torch.distributed.run`` the group comes from its environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; each rank on
``cuda:$LOCAL_RANK``); without it, a world of one that still runs the
collectives. NCCL on the card, gloo on the CPU. The lanes rule reads the global ``--num-envs``. Only rank 0
prints, makes the run directory and writes checkpoints, the CSV export,
``metrics.jsonl`` and the dashboard. ``--terrain-z-curriculum`` is refused
under ``--distributed`` (the JAX package ignores it there).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch
import torch.distributed as dist

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import dashboard
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import mesh as pmesh
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.metrics import JsonlLogger
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils.run_dir import make_run_dir

# the JAX package's rule (cli/train.py:93-118): the batch-in-lanes physics from this
# many envs on, unless --no-lanes; the per-env physics below it, unless --lanes
LANES_MIN_ENVS = 1024


def use_lanes(num_envs: int, lanes: bool, no_lanes: bool) -> bool:
    """Whether training steps the batch-in-lanes physics (``step_batch``, one
    fused kernel launch a control step) or the per-env physics (``step``)."""
    return (lanes or num_envs >= LANES_MIN_ENVS) and not no_lanes


def parse_args(argv):
    p = argparse.ArgumentParser(description="IRRL PPO training (PyTorch port)")
    p.add_argument("--cfg", type=str, default=None, help="environment YAML")
    p.add_argument("--lr", "--l", type=float, default=1e-3, dest="lr")
    p.add_argument("--lr-final", type=float, default=None,
                   help="linear-anneal lr to this value over the run")
    p.add_argument("--max-iter", type=int, default=200_000_000,
                   help="total env steps (reference --max_iter)")
    p.add_argument("--load", type=str, default=None,
                   help="checkpoint .pkl of this port or bp5 CSV dir to warm-start "
                        "(relaxation)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint .pkl to resume params AND optimizer state "
                        "from (interrupted-run continuation; --max-iter then "
                        "counts the REMAINING env steps)")
    p.add_argument("--terrain-z-curriculum", type=str, default=None, metavar="LO,HI",
                   help="linearly ramp the terrain height scale z_scale from LO to HI "
                        "over the run, set before each update (terrain configs only)")
    p.add_argument("--entropy-floor", type=float, default=None,
                   help="minimum policy entropy in nats (logstd projected "
                        "up after each update). Both terrain relaxation "
                        "legs collapsed once entropy fell below ~5.2 "
                        "(docs/evidence/terrain_leg2_r4.md); pass 5.2 to "
                        "pin exploration there for long relaxation legs")
    p.add_argument("--logstd", type=float, default=None,
                   help="override initial logstd (useful when warm-starting "
                        "from a CSV export that predates the logstd.csv field)")
    p.add_argument("--log-dir", type=str, default="runs")
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--n-steps", type=int, default=None,
                   help="rollout/BPTT length override (default: episode_len)")
    p.add_argument("--max-updates", type=int, default=None,
                   help="cap PPO updates directly (overrides --max-iter; "
                        "small smoke runs)")
    p.add_argument("--distributed", action="store_true",
                   help="shard the env batch over the ranks of torch.distributed "
                        "(torch.distributed.run; alone, a world of one)")
    p.add_argument("--lanes", action="store_true",
                   help="batch-in-lanes physics (step_batch: one fused kernel launch a "
                        f"control step); on by itself at --num-envs >= {LANES_MIN_ENVS}")
    p.add_argument("--no-lanes", action="store_true",
                   help="force the per-env physics (step: the dense dynamics, hard contact "
                        "and the meteorite attacks) even at large --num-envs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    env_cfg = cfg_mod.from_yaml(args.cfg) if args.cfg else cfg_mod.train_default()
    state_hook = None
    if args.terrain_z_curriculum:
        if not env_cfg.terrain:
            raise SystemExit("--terrain-z-curriculum needs a terrain config (Terrain: true)")
        if args.distributed:
            raise NotImplementedError(
                "--terrain-z-curriculum is not applied under --distributed (multi-GPU): the JAX "
                "package ignores it there; train the curriculum without --distributed")
        lo, hi = (float(x) for x in args.terrain_z_curriculum.split(","))

        def state_hook(ts: ppo.TrainState, frac: float) -> ppo.TrainState:
            terr = ts.env_state.terrain
            terr = terr._replace(z_scale=torch.full_like(terr.z_scale, lo + (hi - lo) * frac))
            return ts.replace(env_state=ts.env_state.replace(terrain=terr))
    device = dev_mod.resolve(args.device)
    mesh, made_group = None, False
    if args.distributed:
        made_group = pmesh.init_distributed(device=device)
        mesh = pmesh.make_mesh(device)
        device = mesh.device
    try:
        return _main(args, env_cfg, state_hook, device, mesh)
    finally:
        if made_group:
            pmesh.shutdown()


def _main(args, env_cfg, state_hook, device, mesh):
    rank0 = mesh is None or mesh.rank == 0
    log = print if rank0 else (lambda *a, **k: None)
    if args.seed is not None:
        env_cfg = env_cfg.replace(seed=args.seed)
    if args.num_envs is not None:
        env_cfg = env_cfg.replace(num_envs=args.num_envs)
    env_cfg = env_cfg.replace(use_lanes_physics=use_lanes(env_cfg.num_envs, args.lanes,
                                                          args.no_lanes))
    if mesh is not None:   # raises on every rank alike unless the envs split evenly
        lo, hi = pmesh.block(mesh, env_cfg.num_envs)
        log(f"multi-GPU: {mesh.world} ranks over {mesh.backend}, {hi - lo} envs a rank")
    if env_cfg.use_lanes_physics:
        log(f"physics path: batch-in-lanes (num_envs={env_cfg.num_envs}) on {device}")
    else:
        log(f"physics path: per-env (num_envs={env_cfg.num_envs}; lanes from --num-envs "
            f">= {LANES_MIN_ENVS} or with --lanes) on {device}")
    ppo_cfg = ppo.PPOConfig(learning_rate=args.lr, lr_final=args.lr_final,
                            n_steps=args.n_steps or env_cfg.episode_len,
                            entropy_floor=args.entropy_floor)
    if args.max_updates is not None:
        args.max_iter = args.max_updates * env_cfg.num_envs * ppo_cfg.n_steps

    params, opt_state = None, None
    if args.resume:
        params, opt_state, step = mio.load_checkpoint(args.resume, device)
        log(f"resuming params+optimizer from {args.resume} (update {step})")
    elif args.load:
        if os.path.isdir(args.load):
            params = mio.load_bp5_csv(args.load, device=device)
        else:
            params, _, _ = mio.load_checkpoint(args.load, device)
        if args.logstd is not None:
            params.logstd = torch.full_like(params.logstd, args.logstd)

    run_dir = make_run_dir(args.log_dir, env_cfg, [args.cfg] if args.cfg else []) if rank0 else None
    if mesh is not None:   # every rank returns rank 0's run directory
        box = [run_dir]
        dist.broadcast_object_list(box, src=0)
        run_dir = box[0]
    log(f"run dir: {run_dir}")

    def save(ts: ppo.TrainState, tag):
        terr = ts.env_state.terrain
        mio.save_checkpoint(os.path.join(run_dir, f"ckpt_{tag}.pkl"), ts.params, ts.opt_state,
                            ts.update_idx,
                            terrain_z_scale=None if terr is None else float(terr.z_scale.mean()))
        mio.save_bp5_csv(ts.params, os.path.join(run_dir, f"csv_{tag}"))

    with (JsonlLogger(os.path.join(run_dir, "metrics.jsonl")) if rank0
          else contextlib.nullcontext()) as mlog:
        ts = ppo.learn(env_cfg, ppo_cfg, args.max_iter, env_cfg.seed, params,
                       eval_every_n=args.eval_every,
                       callback=(lambda ts, metrics: save(ts, ts.update_idx)) if rank0 else None,
                       verbose=rank0, metrics_hook=mlog.write if rank0 else None,
                       opt_state=opt_state, state_hook=state_hook, device=device, mesh=mesh)
    if not rank0:
        return run_dir
    save(ts, "final")
    try:  # render the curve board beside the raw jsonl (best effort, as the JAX CLI)
        dashboard.training_dashboard(dashboard.load_metrics(run_dir),
                                     os.path.join(run_dir, "dashboard.png"),
                                     title=os.path.basename(run_dir))
    except Exception as e:
        print(f"dashboard render skipped: {e}")
    return run_dir


if __name__ == "__main__":
    main()
