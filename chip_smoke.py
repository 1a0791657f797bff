"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: both hand-written kernels from csrc/ with nvcc (in parallel), with
   ptxas' register and spill report;
3. kernel checks: every kernel entry point against its plain PyTorch version
   on the card (the LSTM's two sequence kernels, one launch a layer each way,
   against autograd of the plain cells at T = 1, 4 and 750: outputs, dx, dc,
   dh, dgates and the weight gradients), at the main path's shapes and two
   ragged batches, then timed (torch.profiler's device time, median of 30
   launches, or CUDA events around a call where no profiler window held its
   events; the sequence kernels at the epochs' T = 750) beside its plain
   version and a library yardstick. The record of each kernel reads the entry
   point the main path launches (the fused control step; the two-tower LSTM
   launch), with the single substep and single cell beside it. The fused
   control step is held by a
   chain: (a) the single substep strictly against the plain substep; (b) the
   fused kernel tightly against 8 x {plain PD torque + single-substep
   kernel}; (c) the fused kernel against its plain loop at the looser
   tolerances of an 8-substep step;
4. serving path: the port's ``cli.test --eval`` at commands 1-5 for 2000
   control steps, with the kernels' launch counts checked (1 physics and 2
   LSTM launches a control step), no falls, and each command's mean speed
   within 0.1 m/s of the JAX package's; then the policy heads through
   ``lstm.row_product`` (the training rollout's) against ``torch.matmul``
   (serving's) at 5, 24, 1024 and 4096 rows, wall a call recorded;
5. full width: a 1024-env closed-loop rollout for 200 control steps, commands
   spread over 0-5 m/s, with env-steps/s, each kernel's share of device time,
   the fall count, and the PyTorch ops the host dispatches a control step,
   split by where they are dispatched;
6. BPTT: on a 32-step rollout's batch at 1024 envs, ``ppo_loss`` and the
   gradient of every parameter leaf through the kernels against the plain
   cells under autograd, with the launch counts checked (one sequence-forward
   and one sequence-backward launch a layer of ``sequence``);
7. training at full width: the port's ``cli.train`` for a few updates at 1024
   envs x 750 steps x 10 epochs, warm-started from the flagship export, with
   the launch counts of every kernel checked, every metric finite, the
   loss falling within each update, the parameters changed, the first
   rollout's reward above a freshly initialised policy's, and the run
   directory's checkpoint and CSV export holding the trained parameters;
   then where an update's time goes;
8. batched SRB solve at the JAX package's bench shape (8192 problems x
   horizon 50, bench.py's problem set): the costs (mean, extremes, and the
   sums of each 1024) and the first 17 problems' plans against the JAX
   package's on the CPU, then solves/s, ms and PyTorch ops a call, the
   device's busy share, peak memory, and the bound;
9. SRB closed loop: the port's ``cli.mpc --engine srb`` at commands 1-5 for
   2500 control steps (commands of one schedule as one batch: 1 physics
   launch a control step of each batch, no LSTM launch, asserted), each
   command's steady speed within 0.1 m/s of the JAX package's and its falls
   equal to JAX's, and within a tighter limit of the same JAX loop stepped
   through the JAX package's lanes physics, the path the port takes; ms a
   control step split into the solve and the env step, timed in the same
   run, and PyTorch ops of each;
10. terrain evaluation: the round-5 terrain policy on
   ``configs/bp5_relax_terrain.yaml`` (the deployment protocol of
   ``scripts/terrain_eval_seeds.py``) at commands 1-3 x the 8 map offsets of
   JAX's ``env_init(cfg, PRNGKey(k))``, k < 8: 24 envs in one batch for 1500
   control steps through both kernels (1 physics and 2 LSTM launches a step,
   asserted). Each rollout's base coordinates after 50 and 100 steps within
   2e-3 of the JAX lanes loop's; per command the mean over the 8 offsets of
   the trailing-40 % forward speed within 0.1 m/s of the JAX lanes loop's,
   and its falls equal to JAX's;
11. terrain training: the port's ``cli.train`` with the flags of
   ``scripts/r5_terrain_leg.sh`` and ``--terrain-z-curriculum 0.05,0.1`` at
   1024 envs x 750 steps x 10 epochs for 2 updates: z_scale 0.05 then 0.1,
   the launch counts of every kernel, finite loss, gradient norm and
   metrics, ``metrics.jsonl``, and the final checkpoint evaluated by
   ``cli.test`` on the terrain config; seconds an update split into rollout,
   GAE and epochs, and PyTorch ops a control step of the terrain rollout;
12. ``analysis.parity.srb_vs_bp5`` at cmd 1 on the flagship artifact (through
   the LSTM and physics kernels) against the JAX package's on the CPU;
13. the whole-body iLQR at bench.py's shape (64 problems x horizon 50 x 8
   iterations, 2 model substeps, linearize_chunk 1; 5 distinct commands,
   each repeated): ``trot.batched_solve`` (dense physics, frozen linearizer,
   no kernel launch) with its warm-start and final costs against the JAX
   package's on the CPU; ``trot.solve_batch_lanes`` with the frozen
   linearizer through the substep kernel ((1 + 8) x 50 x 2 = 900 launches,
   asserted), its warm start against the same solver's on the plain
   substep; and with FD Jacobians (+ 8 x 50 x 2 launches, asserted), below
   its warm start, with the FD Jacobians of one control step through the
   kernel, at the warm start's and the result's states, against the plain
   substep's in float64. The lanes solves' final costs against the plain
   substep's, JAX's and a start 1e-6 m higher are recorded, held by no limit
   (an 8-iteration solve's cost moves as much under that nudge as between
   float orders). Every trace non-increasing, every repeat of a problem bit
   for bit alike; solves/s, ms and PyTorch ops a call, device busy share and
   the kernel's share of it, peak memory, the bound, and the time of a call
   by solver phase;
14. the whole-body receding-horizon loop (``mpc/runtime.wb_*``, the env step
   ``step_batch``: one physics launch a control step, asserted): (a) the
   fleet at bench.py's ``_bench_wb_rh`` configuration (128 robots x h16, 2
   iterations, linearize_chunk 16, relin_every 2) for 15 control steps, a
   batch row against its command alone, controller-steps/s, falls, peak
   memory, the bound, and PyTorch ops, ms and the device's busy share of a
   control step split into dense model steps, linearizer replays, Riccati,
   cost derivatives and the env step; (b) ``cli.mpc --engine wb`` at cmd 1-5
   (3 schedule batches) held to the JAX package's loop on the CPU and to the
   same loop stepping JAX's lanes physics (bases over 15 steps, speed,
   falls); (c) ``analysis.parity.mpc_vs_bp5`` at cmd 1 (through both
   kernels), its solve from JAX's start held to JAX's cost and mae /
   torque_mae to JAX's; (d) a 15-step ``terrain_model=True`` loop on the
   sampled heightmap, finite and upright. Phases 14a-c, 15, 10-12 and 16a
   run in that order in a second process (``--side-worker``) alongside
   phases 7, 8, 16b, 16c, 9, 13, 17a, 17b, 17c, 16d and 14d, whose loops,
   like theirs, are host-bound on one Python thread with the card mostly
   idle (phase 18's rank processes run beside 13, 17a and 17b);
15. the per-env control step (``envs.blackpanther.step``: the dense per-env
   physics in plain PyTorch, no physics launch, asserted; ``--perenv-worker
   PATH`` runs this phase alone): (a) the flagship at cmd 1-5
   under hard contact (``scripts/hard_contact_eval.py``'s protocol) and (b)
   under the meteorite attacks, each as one batch of
   ``analysis.eval.policy_rollout``, held to the JAX package's evaluation on the
   CPU (bases over 15 steps, speed, falls; 2 LSTM pair launches a step); (c)
   ``cli.train`` on ``configs/bp5_train.yaml`` at its 200 envs, which JAX's
   rule puts on the per-env path, then one update of a copy with
   ``HardContact`` and ``Crutial``: the launch counts, finite metrics, the loss
   falling within each update, every parameter changed; (d) ``algo.ppo3.PPO3``
   over ``envs.vec.NumpyVecEnv`` at 200 envs with the flagship's LSTM, then
   with ``MlpPolicy`` through PPO3 and ``ppo.learn`` (no LSTM launch); (e)
   ``step`` (compliant and hard) against ``step_batch`` at 200 and 1024 envs:
   ms, PyTorch ops and synchronized ms a control step by site, busy share,
   peak memory (recorded);
16. the rest of ``cli/test.py`` (``--phase16-worker PATH`` runs phases 2, 3
   and 16 alone): (a) the reward landscape over the three 2×LSTM(48) anchors
   at 2 m/s, step 0.01 (5151 blends as one batch through the per-row LSTM
   kernel and the physics kernel, 750 steps; 2 per-row launches and 1
   physics launch a step, asserted), the per-row kernel against its plain
   twin over the first 50 steps, the 15 blends of step 0.25 against JAX's
   (alive_len, accumulated terms), ms a step, busy share, peak memory;
   (b) ``--kappa-entropy`` at cmd 1, 3, 5 with 4096 episodes for 100 steps;
   (c) ``--kappa`` at cmd 1-5, kick 1 m/s, 1500 steps as one batch, κ held to
   JAX's recovery_sweep; (d) one ``cli.test`` call with ``--torque --wc --ss
   --corr --delay 0,1,2,5 --save-energy-data --dump-info --viewer`` at vx 2,
   then ``value_pca``, ``spectrogram`` and ``toe_trajectories`` on a
   rollout's log, and ``--teleop --serve`` for 200 steps read by a
   ``StateClient``;
17. RefTraj tables, the analytic fractal terrain and the tooling closures
   (``--phase17-worker PATH`` runs phases 2, 3 and 17 alone), in the main
   process after phase 13: (a) the flagship through ``step_batch`` with a
   table synthesized from the gait generator at 1024 envs for 200 steps,
   every env's references and phase observation on its table row at every
   step (1 physics and 2 LSTM launches a step, asserted); (b) the physics
   kernel's analytic-ground instantiation against its plain twin (replayed
   from a CUDA graph) over 50 control steps at 1024 envs, then the terrain
   policy on the analytic terrain at cmd 1-3 x JAX's 8 seeds, 24 envs for
   1500 steps, each command's mean speed held to the JAX lanes loop within
   max(0.1 m/s, 2 x JAX's own spread under a 1e-6 m nudge), falls within
   JAX's range (every physics launch of the two in the analytic mode,
   asserted); (c) ``cli.mpc --viewer`` with ``--engine srb`` (50 steps) and
   ``--engine wb`` (10 steps), and ``NumpyVecEnv`` recording 30 steps to a
   GIF, in the main process after phase 18; (d) phase 7 checks ``dashboard.png`` in the
   training run dir (the dashboard and the GIF are matplotlib figures: on a
   machine without it, their skip is checked and recorded). Phase 3 holds the analytic instantiation to its plain loop for one control
   step, times it beside the flat step and reads its ptxas report.
18. multi-GPU training and the sharded solves over ``torch.distributed``
   (``--phase18-worker PATH`` runs phases 2, 3 and 18 alone, with phase 7's
   first update redone as its reference), in the main process after phase 17b;
   each rank is a process of its own (``--phase18-rank SPEC``) that runs the
   entry point in-process and writes its launches, metrics, the bits of its
   rollout and its parameters: (a) ``cli.train --distributed`` with phase 7's
   arguments for one update at world 1 over NCCL, under
   ``torch.distributed.run --standalone``: the backend, the four kernels'
   launches of one update of phase 7, every metric finite, metrics and
   parameters within 2e-4 of phase 7's first update; (b) the same at world 2
   on the one card over gloo (NCCL refuses two ranks on one device; each rank
   ``LOCAL_RANK=0``, 512 envs): the ranks' parameters bit for bit alike,
   metrics and parameters within 2e-4 of (a)'s, each rank's launches those of
   (a), whether each rank's rollout is bit for bit its block of (a)'s (and
   where it parts, if it does), and each rank's seconds by rollout, GAE,
   epochs and collectives (two ranks on one card measure no scaling); (c)
   ``make_distributed_srb`` at phase 8's 8192 x h50 in both runs and
   ``make_distributed_mpc`` at 64 problems x h16 x 2 iterations at world 2,
   each against the unsharded solve: costs within 1e-5 relative; the SRB's
   plans within 1e-5 and forces within 1e-5 of the largest; the whole-body
   plans and states within 1e-4 (a problem's bits on the card depend on the
   batch's width).

Phase 3 also holds the control step with its Convert2Torque inputs (a torque
feedforward and a PD scale) against its plain loop, at the closed loop's
impulse scale, and checks that leaving them out is bit for bit a feedforward
of 0 and a scale of 1; and the control step on terrain (the heightmap's sum
and 16 samples against the CPU's, then 1024 envs at offsets spread over the
whole map, z_scale 0.1) against its plain loop at (c)'s tolerances, with
z_scale 0 giving the flat kernel's bits, timed with and without terrain;
and the per-row LSTM launch (both towers, a weight set a row) against its
plain version at the landscape's 1326 and 5151 rows and
two ragged batches, timed at 1326 and 5151 against its bytes bound;
and the single substep at the whole-body MPC's dt = 1 ms on the inputs of a
bench-shape lanes solve's launches at each of its lane widths (64; the line
search's 512; the FD sweep's 6272), with the same non-finite lanes on both
sides, timed at 512 and 6272.

The last lines are the kernels' JSON record (``launches_distributed``: phase
18a's), the nvidia-smi line and ``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every
measurement to a JSON file. Needs no JAX and imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from high_speed_quadrupedal_locomotion_by_irrl_torch import config
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo, ppo3
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import parity
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import reftraj, vec
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import mpc as cli_mpc
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as cli_test
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import train as cli_train
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime as mpc_runtime
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import trot
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import (
    _build, lstm_cuda, pd_torque, phys_cuda,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import mesh as pmesh
from high_speed_quadrupedal_locomotion_by_irrl_torch.parallel import train as ptrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import dynamics as dyn
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import hard_contact
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import terrain
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import metrics as metrics_io
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import native

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "irrl_tpu_relaxed_4e8")
EVAL_STEPS = 2000
# v_mean per command of the JAX package on the CPU, produced by
#   JAX_PLATFORMS=cpu python -m high_speed_quadrupedal_locomotion_by_irrl_tpu.cli.test \
#       --model artifacts/irrl_tpu_relaxed_4e8 --eval --commands 1,2,3,4,5 --steps 2000
JAX_V_MEAN = {1.0: 0.963642418384552, 2.0: 1.9871505498886108, 3.0: 3.0224242210388184,
              4.0: 4.038589954376221, 5.0: 4.975755214691162}
V_TOL = 0.1
FULL_B, FULL_STEPS = 1024, 200
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores (TF32 is off)
REPS = 30
# launches a control step on the main path: one fused physics step; one LSTM
# pair launch a layer, two layers
PHYS_LAUNCHES_PER_STEP, LSTM_LAUNCHES_PER_STEP = 1, 2
LSTM_LAYERS = 2   # the flagship's towers: one sequence launch of both a layer, each way
# the first design of each kernel (one thread an env; one thread a row and
# unit), measured by this script on an NVIDIA H100 80GB HBM3 at 700 W before the
# redesign and recorded in PERF.md; quoted in the log beside this run's times,
# never in the kernels' record
PREV_MS = {"phys_substep": 0.0467, "lstm_cell": (0.0211 + 0.0227) / 2}
PREV_CONTROL_STEP_MS = 8 * 0.0467
PREV_TORCH_OPS_PER_STEP = 826
# (gc, gv, toe, toe vel, |f|, fn[, torque]) absolute tolerances
SUBSTEP_ATOL = (1e-5, 1e-3, 1e-5, 1e-3, 5e-3, 5e-3)          # kernel vs plain, one substep
# fused kernel vs 8 x {plain torque + substep kernel}: one device body behind both, but
# the torque rounds otherwise in the kernel and 8 stiff substeps carry that on
FUSED_ATOL = (1e-5, 1e-3, 1e-5, 1e-3, 2e-2, 2e-2, 1e-3)
# fused kernel vs its plain loop: the single-substep differences (another summation
# order, the leg-first solve) fed back through the PD law and the contacts for 8 substeps
STEP_ATOL = (1e-5, 1e-2, 1e-5, 1e-2, 0.2, 0.2, 1e-2)
PROF_STEPS = 20
DEVICE = "cuda"
# training: the production shape (cli/train.py at 1024 envs; n_steps = episode_len = 750,
# 10 epochs of one minibatch); only the number of updates is cut
TRAIN_CFG = os.path.join(ROOT, "high_speed_quadrupedal_locomotion_by_irrl_torch", "configs",
                         "bp5_train.yaml")
TRAIN_UPDATES, TRAIN_STEPS, TRAIN_EPOCHS = 2, 750, 10
TRAIN_LOG_DIR = os.path.join(ROOT, "runs", "chip_smoke")
BPTT_STEPS = 32      # the plain path's autograd graph at 750 steps would not be a fair use of memory
SEQ_REPS = 10              # sequences timed at TRAIN_STEPS
# the per-step training kernels these replaced, a launch of both towers (PERF.md's kernel table)
PREV_SEQ_STEP_MS = {"train": {35: 0.0087, 48: 0.0091}, "bwd": {35: 0.0098, 48: 0.0131}}
GRAD_RTOL = 1e-4     # a gradient against autograd's, relative to the leaf's largest entry
# the SRB closed loop's contact: high_speed_setup's contact_impulse_mass over simulation_dt
MPC_IMPULSE_MASS = 2.0
# the JAX package's bench shape for the batched SRB solve (bench.py:408-409)
SRB_BATCH, SRB_HORIZON, SRB_REPS = 8192, 50, 10
# the JAX package's batched solve of that problem set on the CPU, produced by
#   JAX_PLATFORMS=cpu python tests/test_torch_srb.py
# mean, min and max cost over the 8192 problems, then one row each for the first 17:
# cost, the forces (12) and us (12) of knot 0, the 2-norms of all 50 knots' forces and us
JAX_SRB_COST = dict(mean=0.001897996524348855, min=0.0009499870939180255,
                    max=0.007576554547995329)
JAX_SRB_ROWS = [
    [0.002949498, -0, -0, 0, 4.542856, 4.542856, 7.571426, 12.99728, 7.44045, 69.95108, -0, -0,
     0, -4.939694e-09, -0.1853645, -0.009976625, -0.05016057, 0.1049232, -0.06356692,
     0.09284285, -0.03645482, -0.361719, 4.939694e-09, -0.1853645, -0.009976625, 510.7332,
     4.449226],
    [0.0029329, -0, -0, 0, 2.806091, 2.806091, 4.676819, 12.38167, 7.954738, 68.81784, -0, -0,
     0, -1.096783e-09, -0.2193587, -0.02097058, -0.03098384, 0.1671352, -0.06042366,
     0.08657754, -0.004366592, -0.3751372, 1.096783e-09, -0.2193587, -0.02097058, 512.446,
     4.612261],
    [0.002863343, -0, -0, 0, 1.226477, 1.226477, 2.044128, 11.82807, 8.351053, 67.19812, -0,
     -0, 0, 4.334194e-09, -0.2505232, -0.03155077, -0.01354231, 0.2269918, -0.06063253,
     0.08016326, 0.02785446, -0.3873038, -4.334194e-09, -0.2505232, -0.03155077, 512.8518,
     4.799672],
    [0.002724114, -0, -0, 0, 0, 0, 0, 11.32185, 8.610062, 65.24069, -0, -0, 0, -3.490589e-09,
     -0.279206, -0.03958976, 2.023094e-08, 0.2803439, -0.06507695, 0.07406113, 0.05924105,
     -0.3975801, 3.490589e-09, -0.279206, -0.03958976, 512.2041, 5.012805],
    [0.002554863, -0, -0, 0, 0, 0, 0, 10.8868, 8.73582, 63.13327, -0, -0, 0, -3.748332e-10,
     -0.3061202, -0.04269361, 2.023094e-08, 0.3151741, -0.08162963, 0.06863965, 0.08824096,
     -0.4055851, 3.748332e-10, -0.3061202, -0.04269361, 510.2139, 5.245253],
    [0.002328237, -0, -0, 0, 0, 0, 0, 10.46135, 8.714556, 61.00986, -0, -0, 0, 4.448901e-09,
     -0.3321706, -0.03842854, 2.023094e-08, 0.3431042, -0.09592211, 0.06428687, 0.1139072,
     -0.4104764, -4.448901e-09, -0.3321706, -0.03842854, 507.3946, 5.50502],
    [0.002101887, -0, -0, 0, 0, 0, 0, 10.09175, 8.575238, 59.07022, -0, -0, 0, -1.373501e-08,
     -0.3582263, -0.02461076, 2.023094e-08, 0.3629717, -0.1066325, 0.06121001, 0.1342731,
     -0.4121347, 1.373501e-08, -0.3582263, -0.02461076, 503.8231, 5.782057],
    [0.001846578, -0, -0, 0, 0, 0, 0, 9.683514, 8.295948, 57.35571, -0, -0, 0, -9.090345e-09,
     -0.3848528, 0.0003657341, 2.023094e-08, 0.3738003, -0.1126584, 0.05966134, 0.1488836,
     -0.4095071, 9.090345e-09, -0.3848528, 0.0003657341, 499.5121, 6.089457],
    [0.001634742, -0, -0, 0, 0, 0, 0, 9.334673, 7.927034, 56.06552, -0, -0, 0, -4.176258e-09,
     -0.4120347, 0.03721929, 2.023094e-08, 0.3748177, -0.1132313, 0.05968654, 0.1556019,
     -0.4030965, 4.176258e-09, -0.4120347, 0.03721929, 495.1559, 6.414096],
    [0.001416195, -0, -0, 0, 0, 0, 0, 8.92716, 7.426517, 55.10324, -0, -0, 0, 2.085412e-09,
     -0.4389334, 0.08555734, 2.023094e-08, 0.365474, -0.1080133, 0.06139557, 0.1549584,
     -0.3917943, -2.085412e-09, -0.4389334, 0.08555734, 490.038, 6.773575],
    [0.00128289, -0, -0, 0, 0.811496, 0.811496, 1.352493, 8.638543, 6.866085, 54.67761, -0, -0,
     0, -1.173008e-08, -0.4637077, 0.1437849, -0.00896024, 0.336012, -0.1057442, 0.06469435,
     0.1448007, -0.3771589, 1.173008e-08, -0.4637077, 0.1437849, 485.5978, 7.152035],
    [0.001148129, -0, -0, 0, 2.846869, 2.846869, 4.744781, 8.324228, 6.179367, 54.52412, -0,
     -0, 0, 8.431198e-09, -0.4834225, 0.2091444, -0.03143412, 0.2824622, -0.1114909,
     0.06951858, 0.126968, -0.358107, -8.431198e-09, -0.4834225, 0.2091444, 480.4104,
     7.570852],
    [0.001132332, -0, -0, 0, 5.282401, 3.347953, 8.804001, 8.263997, 5.464914, 54.87669, -0,
     -0, 0, -1.685015e-08, -0.4940634, 0.2778372, -0.04381807, 0.2158566, -0.1177878,
     0.0756262, 0.09927413, -0.3375347, 1.685015e-08, -0.4940634, 0.2778372, 476.6972,
     8.013697],
    [0.001100349, -0, -0, 0, 8.37519, 3.256502, 13.95865, 8.263983, 4.636135, 55.26457, -0, -0,
     0, 5.731511e-09, -0.4907179, 0.3451724, -0.05408581, 0.1353854, -0.1290654, 0.08266629,
     0.0649764, -0.3141936, -5.731511e-09, -0.4907179, 0.3451724, 472.3589, 8.504456],
    [0.001210473, -0, -0, 0, 8.933567, 3.118803, 19.60295, 8.717317, 3.827218, 55.97823, -0,
     -0, 0, 5.937915e-09, -0.4680376, 0.4057189, -0.0650472, 0.06877055, -0.134404, 0.09024968,
     0.02170748, -0.292509, -5.937915e-09, -0.4680376, 0.4057189, 470.1841, 9.027143],
    [0.001291155, -0, -0, 0, 9.368576, 2.796554, 26.20464, 9.324239, 2.941801, 56.29903, -0,
     -0, 0, -2.38655e-08, -0.4211352, 0.4535013, -0.07665891, 0.000507711, -0.1445738,
     0.097572, -0.02587111, -0.2707334, 2.38655e-08, -0.4211352, 0.4535013, 466.9655,
     9.601276],
    [0.001541792, -0, -0, 0, 10.51256, 2.393184, 32.78383, 10.58602, 2.152566, 56.66991, -0,
     -0, 0, -1.113778e-08, -0.3469518, 0.4823829, -0.08761442, -0.07089754, -0.1600936,
     0.1042794, -0.08039937, -0.2552769, 1.113778e-08, -0.3469518, 0.4823829, 466.4612,
     10.22209],
]
# Costs of a problem whose gait clock at a knot lands on a phase boundary up to
# rounding depend on which side the float32 clock rounds to, which differs between
# XLA's fused graph and eager PyTorch: on the CPU these 36 of the 8192 costs differ by up
# to 8.8 % (the others by <= 4.1e-6), moving the mean by 3.5e-5 and the extremes by
# < 5e-7 (the same command prints it)
JAX_SRB_BOUNDARY = [24, 48, 58, 106, 116, 208, 270, 290, 480, 580, 842, 1042, 1142, 2718,
                    3018, 3218, 3518, 3718, 4018, 4218, 4518, 4718, 5018, 5218, 5436, 5536,
                    5936, 6036, 6436, 6536, 6936, 7036, 7436, 7536, 7936, 8036]
# the sum of the costs of each 1024 problems in order, JAX_SRB_BOUNDARY left out (float64)
JAX_SRB_CHUNK_SUMS = [1.920363448036369, 1.945336415374186, 1.9394633445772342,
                      1.9265224026166834, 1.9176534319994971, 1.9436724539264105,
                      1.9416676516993903, 1.9386278506135568]
SRB_COST_MEAN_RTOL, SRB_COST_EXTREME_RTOL, SRB_CHUNK_RTOL = 1e-3, 1e-4, 1e-5
# the first 17 problems, on the CPU against JAX: 1.1e-6 relative on the cost, 1.5e-4 N on
# forces of up to 72 N, 1e-6 on us; held at some 10x that
SRB_ROW_RTOL, SRB_FORCE_ATOL, SRB_US_ATOL = 1e-5, 2e-3, 1e-5
# 2500 control steps: the JAX package's cli/mpc.py default and its README table's protocol.
# At 2000 the JAX package's per-env physics is still accelerating at cmd 3 (2.80 m/s over
# the last 40 %, 2.93 at 2500) where its own lanes physics, and the port's, hold 3.00
# (JAX_PLATFORMS=cpu python tests/test_torch_mpc.py divergence 3 2000), and the port
# misses the per-env reference there by 0.20 m/s: the 0.1 m/s limit below holds only from
# 2500 steps, which is why the loop runs that long
MPC_STEPS, MPC_COMMANDS = 2500, "1,2,3,4,5"
# steady forward speed (trailing 40 %) and falls per command of the JAX package's
# cli/mpc.py --engine srb on the CPU at MPC_STEPS, unrounded, produced by
#   JAX_PLATFORMS=cpu python tests/test_torch_mpc.py 2500
JAX_MPC_V_FALLS = {1.0: (0.9846953749656677, 0), 2.0: (1.9064708948135376, 0),
                   3.0: (2.9260687828063965, 0), 4.0: (2.9338197708129883, 0),
                   5.0: (3.1843690872192383, 0)}
# the same loop with the JAX package's env stepped through its lanes physics, the path
# the port's loop takes (steady forward speed as above), produced by
#   JAX_PLATFORMS=cpu python tests/test_torch_mpc.py lanes 2500
JAX_MPC_LANES_V = {1.0: 0.9847082495689392, 2.0: 1.9063785076141357, 3.0: 3.0022518634796143,
                   4.0: 2.931133270263672, 5.0: 3.181004047393799}
# the port on an NVIDIA H100 80GB HBM3 (700 W) reads within 0.0014 m/s of these at every
# command (PERF.md), where the per-env reference lies up to 0.077 m/s away at cmd 3; held
# at some 7x that
MPC_LANES_TOL = 0.01
# srb_vs_bp5 at cmd 1 (warmup 200, horizon 50) of the JAX package on the CPU, from the
# same command
JAX_SRB_VS_BP5 = {"mae": 0.16217844188213348, "mae_stance": 0.13062961399555206,
                  "mae_swing": 0.19501498341560364}
# the port's plain path on the CPU reads each within 3e-8 of these; the kernels sum the
# 251 policy steps in another order (serving: v_mean within 1e-4 m/s of JAX over 2000 steps)
SRB_VS_BP5_ATOL = 1e-3
# terrain: the heightmap (phys/terrain.fractal_grid, float32 from float64 numpy): its
# float64 sum and 16 samples at TERRAIN_GRID_AT, on the CPU
TERRAIN_GRID_SUM = -5344.233182615517
TERRAIN_GRID_AT = [(iy, ix) for iy in (0, 137, 311, 499) for ix in (0, 1234, 3777, 4999)]
TERRAIN_GRID_SAMPLES = [-1.0215143, 0.000930800452, -0.0437323749, 0.614381552, 0.573010445,
                        0.468553603, -0.0701041594, -0.0857668743, -0.360639185, 0.398596466,
                        0.331270993, 0.529157877, 0.467479616, -0.329513848, 0.685890794,
                        0.1813609]
# operations of one lookup: clip((p + off) / cell) and floor and the fraction, per axis;
# the bilinear weights, products and sum; the scale; the penetration's p - h
TERRAIN_LOOKUP_OPS = 2 * 6 + 2 + 8 + 3 + 1 + 1
TERRAIN_LOOKUPS_PER_ENV = 4 + 8   # a substep: the 4 toes and the 8 base corners
TERRAIN_CFG = os.path.join(ROOT, "high_speed_quadrupedal_locomotion_by_irrl_torch", "configs",
                           "bp5_relax_terrain.yaml")
# the round-5 terrain pick (its README.txt and docs/evidence/terrain_entropy_floor_r5.md),
# and the warm start of the round-5 terrain leg (scripts/r5_terrain_leg.sh)
TERRAIN_EVAL_ARTIFACT = os.path.join(ROOT, "artifacts", "irrl_tpu_terrain_relaxed_r5")
TERRAIN_TRAIN_ARTIFACT = os.path.join(ROOT, "artifacts", "irrl_tpu_terrain_relaxed")
TERRAIN_STEPS, TERRAIN_K, TERRAIN_COMMANDS = 1500, 8, (1.0, 2.0, 3.0)
TERRAIN_BASE_ATOL = 2e-3
TERRAIN_TRAIN_UPDATES, TERRAIN_Z = 2, (0.05, 0.1)
TERRAIN_TRAIN_LOG_DIR = os.path.join(ROOT, "runs", "chip_smoke_terrain")
FLAT_TRAIN_OPS_PER_STEP = 1356   # the flat training rollout's, PERF.md (PR 3, PR 4)
# The JAX package on the CPU, produced by
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_terrain.py lanes 1500
# the 8 offsets (JAX env_init(cfg, PRNGKey(k)) splits k_tr from the key; terrain.py:110-118);
# per command the trailing-40 % forward speed of each offset's rollout (signed as
# tracking_eval signs it; WILDCAT) and the falls of all 8, of the JAX loop stepped through
# its lanes physics (the port's path: step_batch with ground_fn, a vertical contact normal)
# with all 24 rollouts in one batch; and per command and offset the base coordinates
# (gc[:7]) after 50 and 100 control steps of that loop
JAX_TERRAIN_OFFSETS = [[52.91752624511719, 5.825139999389648],
                       [211.4585418701172, 26.907268524169922],
                       [448.273193359375, 25.30275535583496],
                       [60.397857666015625, 26.621549606323242],
                       [305.1337890625, 28.129886627197266],
                       [83.52532958984375, 14.143020629882812],
                       [127.15415954589844, 24.987327575683594],
                       [320.0534362792969, 37.97855758666992]]
JAX_TERRAIN_LANES = {1.0: ([0.8206678032875061, 0.8592565059661865, 0.7321487665176392,
                            0.8692985773086548, 0.9118210673332214, 0.8366967439651489,
                            0.7661536335945129, 0.7598686814308167],
                           0),
                     2.0: ([2.194965124130249, 2.2446839809417725, 2.225972890853882,
                            2.235283613204956, 2.2577977180480957, 1.9908078908920288,
                            2.2014458179473877, 2.1291580200195312],
                           0),
                     3.0: ([2.986271381378174, 2.834362268447876, 3.5060689449310303,
                            3.397728681564331, 2.53635311126709, 3.0702881813049316,
                            3.3686041831970215, 2.9432032108306885],
                           0)}
JAX_TERRAIN_BASE = [[[[0.00068636128, -0.00307377963, 0.254630417, 0.999886096, 0.0101633603,
                       0.0101740733, 0.00457480457],
                      [-0.0269276313, -0.0186046306, 0.240167141, 0.999459863, 0.0138910133,
                       0.0184243228, 0.0234009773]],
                     [[0.000717094401, 0.000149674524, 0.321831614, 0.999787986, 0.00281912158,
                       0.020398099, 0.000230996025],
                      [-0.0306765754, -0.0022616412, 0.306955159, 0.999001503, 0.00800363161,
                       0.043824885, -0.00334339589]],
                     [[0.000913254335, -0.000565577357, 0.23354204, 0.999988496, 0.00473866286,
                       -0.000429404608, 0.000579877465],
                      [-0.0347471051, -0.00315763103, 0.202471823, 0.999973655, 0.00538499514,
                       -0.00478655566, 0.000852041645]],
                     [[0.00123400625, -0.000505152682, 0.283813566, 0.999934494, 0.00293399813,
                       -0.0110600749, 0.000180275863],
                      [-0.0320857689, 0.000711625325, 0.259005815, 0.999656975, 0.00395542337,
                       -0.025281623, -0.00557140447]],
                     [[0.000756727823, -0.000370726397, 0.388425648, 0.999904931, 0.00269755558,
                       0.0134045146, 0.00176328956],
                      [-0.0327811576, -0.00491760066, 0.368689269, 0.999385476, 0.00752799492,
                       0.0340412371, 0.00363318273]],
                     [[0.00119343121, 0.000152486056, 0.257116377, 0.999979496, 0.00128420058,
                       -0.00625846861, -0.00039813554],
                      [-0.0298750494, 0.00611544214, 0.234040409, 0.999750197, 0.00163149333,
                       -0.0191986039, -0.0113239558]],
                     [[0.000932379626, 1.27971107e-05, 0.251153052, 0.999968886, 0.00324629503,
                       0.00718627404, 0.000134158327],
                      [-0.0330764167, -0.000234658466, 0.22834231, 0.999912679, 0.00560192205,
                       0.0119530028, -0.000594474084]],
                     [[0.000806411321, 9.39280435e-05, 0.379364997, 0.999956489, 0.00308805541,
                       0.00879961532, 0.000283834466],
                      [-0.0349948332, -0.000164863464, 0.355602741, 0.99976331, 0.00692852121,
                       0.0202984698, -0.00363326725]]],
                    [[[-0.00209072093, -0.00138651079, 0.251019478, 0.999572814, 0.0112926234,
                       0.0265546516, 0.0046435874],
                      [-0.0391661637, -0.0155802676, 0.245990634, 0.997319281, 0.0124766277,
                       0.0708143637, 0.013559944]],
                     [[-0.00319665717, 0.00128744647, 0.321379095, 0.999345183, 0.00349108549,
                       0.0359342992, -0.00236508297],
                      [-0.0401659422, 0.0029714338, 0.322217971, 0.995525122, 0.00336218462,
                       0.0922164842, -0.0203590449]],
                     [[-0.000891760807, 0.000285227346, 0.23307845, 0.999855161, 0.00497265579,
                       0.0162683222, 0.000438404328],
                      [-0.0397732072, -0.00301493565, 0.214962289, 0.998516798, 0.00650163554,
                       0.053437721, -0.00813833252]],
                     [[-0.000239748304, 0.000186999285, 0.278395504, 0.999927521, 0.00616504392,
                       0.0103401495, -3.36715093e-05],
                      [-0.0399683267, -0.0010826498, 0.250919133, 0.999477327, 0.00681333663,
                       0.0297900289, -0.0105459159]],
                     [[-0.00228399341, 0.000717322109, 0.389812022, 0.999570847, 0.0044175717,
                       0.0289509892, -0.000681889185],
                      [-0.0391914286, 0.00058540277, 0.384982318, 0.996436179, 0.00348174409,
                       0.083233282, -0.0132308211]],
                     [[-0.000654875825, 0.00100561883, 0.251867682, 0.999886692, 0.00297403568,
                       0.0146425366, -0.0018230353],
                      [-0.0392895937, 0.00734135602, 0.224462971, 0.998884022, 0.00322074816,
                       0.0374685228, -0.0285743009]],
                     [[-0.00143572432, 0.00104351691, 0.250603259, 0.999753118, 0.00248191669,
                       0.0220109336, -0.00175390625],
                      [-0.0400763005, 0.00330639002, 0.241032451, 0.997485399, 0.00296433666,
                       0.067888543, -0.0201306939]],
                     [[-0.0016085325, 0.000852614758, 0.380244941, 0.999721229, 0.0031145066,
                       0.0233743507, -0.00120226922],
                      [-0.039817173, 0.00126769708, 0.371159971, 0.997269809, 0.00399314985,
                       0.0717508048, -0.0169957913]]],
                    [[[-0.0044021043, -0.000664544466, 0.250415087, 0.999287665, 0.010978994,
                       0.0358560309, 0.00422475068],
                      [-0.0362186283, -0.00943816174, 0.243543267, 0.994608343, 0.00850646012,
                       0.10323479, 0.00494434964]],
                     [[-0.00541838165, 0.00166938535, 0.321338862, 0.999047935, 0.00435261009,
                       0.0432887152, -0.00321899215],
                      [-0.0389344245, 0.00596976606, 0.321340829, 0.993132889, -0.000279272877,
                       0.113603838, -0.0279486794]],
                     [[-0.00292658294, 0.000827089942, 0.233909041, 0.999637723, 0.0059426818,
                       0.0262434166, -0.000570159173],
                      [-0.036243923, 0.00228663953, 0.213009968, 0.996262372, 0.00218571001,
                       0.0840167329, -0.0199423693]],
                     [[-0.0022235238, 0.000846713665, 0.278681844, 0.999753475, 0.00437570363,
                       0.0217559636, -0.000745650148],
                      [-0.0349728167, 0.00382585195, 0.24868679, 0.997218251, 0.000645208987,
                       0.0709980428, -0.0226839315]],
                     [[-0.00466512656, 0.00132234278, 0.390161812, 0.999261856, 0.00515679782,
                       0.0380100682, -0.00208231923],
                      [-0.0384849124, 0.00453636376, 0.385345697, 0.994052529, 0.000218463349,
                       0.106231764, -0.0239643529]],
                     [[-0.0026474765, 0.001562519, 0.252363592, 0.99968183, 0.000884417212,
                       0.0250204206, -0.0030635458],
                      [-0.0357430466, 0.0094117308, 0.224991828, 0.996524096, -0.00368532725,
                       0.0748420805, -0.0363975354]],
                     [[-0.00347875012, 0.0015579419, 0.2507267, 0.999530852, 0.00248133205,
                       0.0303799082, -0.00299846521],
                      [-0.0373347253, 0.00754362578, 0.234381288, 0.995393634, -0.00179565663,
                       0.0904549733, -0.0317195132]],
                     [[-0.00386988884, 0.00141640299, 0.380802721, 0.999448299, 0.00403415971,
                       0.0328763686, -0.00245685293],
                      [-0.0379060991, 0.00575478189, 0.369173557, 0.994928241, -0.000194636596,
                       0.0966926217, -0.0277177524]]]]

# phase 13: the whole-body iLQR at bench.py's shape (_bench_ilqr, bench.py:174-212, 409-440):
# 64 problems x horizon 50 x 8 iterations, 2 model substeps, linearize_chunk 1; commands
# 1 + 3 (i % 5) / 4 from the stand pose, i.e. 5 distinct problems, each repeated; each
# solver timed on one call after its checked one (phase 14 needs the time a median of 3 took)
WB_BATCH, WB_HORIZON, WB_ITERS, WB_DISTINCT, WB_REPS = 64, 50, 8, 5, 1
# the JAX package's batched_solve (frozen linearizer) of the 5 distinct problems on the CPU,
# unrounded, produced by
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb.py bench
# the warm start's cost (0 iterations), then the cost after 8 iterations
JAX_WB_WARM_COST = [666.7714233398438, 1192.0445556640625, 2062.811279296875,
                    3317.393310546875, 4989.18017578125]
JAX_WB_COST = [380.0652770996094, 1006.8085327148438, 808.282470703125, 1366.2529296875,
               2217.344970703125]
# Limits, fixed before the first run on the H100. The warm starts (one rollout, no step
# taken): the dense solver reads within 3.0e-4 of JAX's on the CPU: held at 2e-3 (the kernel's
# lanes solver reads within 5.9e-4 of the plain substep's on the card). The dense solver's
# final costs after 8 iterations: 5e-2 of JAX's, JAX's own lanes-vs-vmap tolerance
# (tests/test_mpc.py:169-170); it reads within 3.7e-2 on the card.
WB_WARM_RTOL = 2e-3
WB_COST_RTOL = 5e-2
# The lanes solvers' final costs are recorded against the plain substep's and JAX's, and held
# by no limit: at this shape an 8-iteration solve's cost moves with a 1e-6 m change of the
# start height, as much as it moves between float orders. On the CPU the plain substep's own
# lanes solve moves by up to 13 % (frozen, cmd 1) and 128 % (FD, cmd 2.5) under it, and its
# float64 FD solve reads 2.23 x the float32 one's cost at cmd 2.5, produced by
#   PYTHONPATH=. python tests/test_torch_wb.py witness
# (5e-2 on the frozen run and 0.8-1.6 x the frozen run's on the FD run, fixed before the
# first run on the H100, failed there at cmd 2.5 by 5.1 % and at cmd 1 / 2.5 by 1.63 / 2.22).
# What the kernel adds to a lanes solve is held where no step-size decision intervenes: the
# warm start above, every lane width's last launch in phase 3, and the FD Jacobians below.
# WB_NUDGE_M: the start-height change whose effect on the kernel's own solve is recorded
WB_NUDGE_M = 1e-6
# the central-FD Jacobian of one control step (fd_eps 1e-3) through the kernel against the
# same through the plain substep in float64, on the 250 states of the 5 distinct problems'
# warm start and of the FD solve's result: relative Frobenius error per state. The plain
# substep in float32 reads median 9.7e-5 / 8.6e-5 and max 2.7e-4 / 5.5e-4 (warm start / final
# states) on the CPU (the witness command above): held at 1e-3 (median) and 1e-2 (max)
WB_JAC_RTOL_MEDIAN, WB_JAC_RTOL_MAX = 1e-3, 1e-2
# the single substep at the MPC's dt = 1 ms, kernel against plain, on the states of a real
# line search and FD sweep: SUBSTEP_ATOL with the velocity and force rows x 4 (the substep
# is 4x as long), and those rows also relative, since a line search's rollouts can fall
MPC_SUBSTEP_ATOL = (1e-5, 4e-3, 1e-5, 4e-3, 2e-2, 2e-2)
MPC_SUBSTEP_RTOL = 1e-4

# phase 14: the whole-body receding-horizon loop (mpc/runtime.wb_*). Every limit below was
# fixed before the phase's first run on the H100.
# (a) the fleet at bench.py's _bench_wb_rh (bench.py:214-245): 128 robots, horizon 16, 2
# iterations, linearize_chunk 16, the Jacobians of every 2nd iteration, the frozen
# linearizer, commands 0.5 + 2.5 (i % 8) / 7; 15 control steps where bench.py takes 100
# (the only cut)
WB_FLEET_B, WB_FLEET_STEPS = 128, 15
WB_FLEET_MC = dict(horizon=16, n_iter=2, model_substeps=2, linearize_chunk=16, n_alphas=4,
                   relin_every=2, linearizer="frozen")
# row 1 of a 2-command batch against that command alone over 10 steps: gc within 1e-4
# (the JAX package's test_wb_mpc_fleet_batch_matches_single)
WB_FLEET_CHECK_STEPS, WB_FLEET_ATOL = 10, 1e-4
# (b) cli.mpc --engine wb at cmd 1-5 (3 schedule batches: {1, 2}, {3}, {4, 5}) for
# WB_TRACK_STEPS control steps each, against two JAX loops on the CPU at the same length,
# both from JAX's start with JAX's dense MPC model: JAX's own loop (the per-env bp.step) and
# the same loop stepping JAX's lanes physics (step_batch), the port's path. Produced by
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py witness 150 <N>
# per command: the trailing-40 % forward speed and falls of both loops, the largest move of
# either speed when the start is 1e-6 m higher or lower (nudge_spread), the lanes loop's mean
# solve cost, the first step where the two JAX loops' bases part by 1e-3; and the lanes
# loop's bases (gc[:3]) over the first 40 steps
# N = 60 steps, the least the phase may take: a control step of a batch is host-bound, 0.9-1.4 s
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), so (b) alone takes 160-250 s
WB_TRACK_COMMANDS = "1,2,3,4,5"
WB_TRACK_STEPS = 60
JAX_WB_TABLE = {
    1.0: {"v_lanes": -0.00032585239387117326, "v_per_env": -3.502052277326584e-05, "falls_lanes":
         0, "falls_per_env": 0, "nudge_spread": 0.01076766662299633, "cost_lanes":
         67.53113555908203, "lanes_vs_per_env_first_1e-3": 57},
    2.0: {"v_lanes": -0.0023493764456361532, "v_per_env": -0.0057617127895355225, "falls_lanes": 0,
         "falls_per_env": 0, "nudge_spread": 0.006280815461650491, "cost_lanes":
         203.16712951660156, "lanes_vs_per_env_first_1e-3": None},
    3.0: {"v_lanes": 0.06613557785749435, "v_per_env": 0.06653154641389847, "falls_lanes": 0,
         "falls_per_env": 0, "nudge_spread": 0.004070654511451721, "cost_lanes": 392.2254943847656,
         "lanes_vs_per_env_first_1e-3": None},
    4.0: {"v_lanes": 0.18774037063121796, "v_per_env": 0.19313187897205353, "falls_lanes": 0,
         "falls_per_env": 0, "nudge_spread": 0.008359730243682861, "cost_lanes": 859.7212524414062,
         "lanes_vs_per_env_first_1e-3": None},
    5.0: {"v_lanes": 0.18720358610153198, "v_per_env": 0.1886332482099533, "falls_lanes": 0,
         "falls_per_env": 0, "nudge_spread": 0.0019993484020233154, "cost_lanes":
         1350.7723388671875, "lanes_vs_per_env_first_1e-3": None}}
JAX_WB_BASES = {
    1.0: [[1.26965433e-05, -1.75410086e-08, 0.349965274], [3.82550206e-05, -3.60862416e-08,
         0.349876374], [6.86821222e-05, -4.97465926e-08, 0.349739254], [0.000102868587,
         -7.49107514e-08, 0.349554151], [0.00014094697, -1.21480056e-07, 0.349320114],
         [0.000183235621, -1.9778777e-07, 0.349036038], [0.000229999729, -3.13420372e-07,
         0.348700821], [0.000281363347, -4.80047277e-07, 0.348313689], [0.000337254867,
         -7.11286191e-07, 0.347874105], [0.000397364085, -1.02184731e-06, 0.347382069],
         [0.000461117103, -1.4259299e-06, 0.346838057], [0.000527666765, -1.93486335e-06,
         0.346243382], [0.000595905352, -2.55421924e-06, 0.345600128], [0.000664502382,
         -3.28030274e-06, 0.344911128], [0.000731958309, -4.09686982e-06, 0.344180048],
         [0.000796679349, -4.97306519e-06, 0.343411237], [0.000857056351, -5.86310398e-06,
         0.342609674], [0.000911543961, -6.70812142e-06, 0.341780424], [0.000958734076,
         -7.44096997e-06, 0.340928614], [0.000997413765, -7.99335066e-06, 0.340058923],
         [0.0010266084, -8.3043351e-06, 0.339175463], [0.00104561192, -8.32870683e-06,
         0.338281065], [0.00105400605, -8.04327829e-06, 0.337377489], [0.00105167041,
         -7.44977388e-06, 0.336465061], [0.00103878567, -6.57380951e-06, 0.335542798],
         [0.00101582729, -5.46041383e-06, 0.334608495], [0.000983547885, -4.16733201e-06,
         0.333658874], [0.000942951825, -2.75767138e-06, 0.33269003], [0.000895262812,
         -1.29326304e-06, 0.331697464], [0.000841879228, 1.70561918e-07, 0.330676556],
         [0.000784320117, 1.5882589e-06, 0.329622656], [0.0007241696, 2.92559184e-06, 0.328531504],
         [0.000663009298, 4.15962859e-06, 0.327399164], [0.000602589746, 5.26090207e-06,
         0.326222509], [0.000544045935, 6.26762039e-06, 0.324998498], [0.000488266785,
         7.11716802e-06, 0.32372278], [0.000436443952, 7.80877235e-06, 0.322394878],
         [0.000389491732, 8.39953373e-06, 0.321016282], [0.000346904329, 8.93491415e-06,
         0.319586843], [0.000309146795, 9.40773498e-06, 0.318107277]],
    2.0: [[9.32001967e-06, -1.60103166e-08, 0.349968016], [3.74201773e-05, -4.06445686e-08,
         0.34987843], [7.91813873e-05, -7.02817218e-08, 0.349732995], [0.000128195315,
         -1.26826393e-07, 0.349534035], [0.000183411656, -2.25281113e-07, 0.34928149],
         [0.00024476106, -3.762012e-07, 0.348974884], [0.000312249002, -5.90228979e-07,
         0.348613739], [0.000385732361, -8.78701996e-07, 0.348197758], [0.000464836688,
         -1.25497115e-06, 0.347726941], [0.000548888114, -1.73060948e-06, 0.347201854],
         [0.000636964629, -2.31831996e-06, 0.346623659], [0.000727789477, -3.02340641e-06,
         0.345994145], [0.000819757406, -3.83799306e-06, 0.345316172], [0.000911018404,
         -4.73745058e-06, 0.344593495], [0.000999537762, -5.68431096e-06, 0.343830377],
         [0.00108314189, -6.61923923e-06, 0.343031943], [0.00115957879, -7.45949228e-06,
         0.342203856], [0.00122667663, -8.11042992e-06, 0.341351867], [0.00128238113,
         -8.47302454e-06, 0.34048149], [0.00132485619, -8.45632621e-06, 0.339597583],
         [0.00135258143, -7.99075406e-06, 0.33870402], [0.001364414, -7.03869864e-06, 0.337803274],
         [0.00135968241, -5.60043964e-06, 0.336896092], [0.00133825268, -3.71330702e-06,
         0.335981876], [0.00130057393, -1.44469323e-06, 0.335058421], [0.00124762673,
         1.11936549e-06, 0.334122419], [0.00118090631, 3.88542685e-06, 0.333169878],
         [0.00110228022, 6.76284344e-06, 0.332196206], [0.00101389084, 9.67044798e-06,
         0.331196845], [0.0009180489, 1.25400784e-05, 0.330167234], [0.000817106105,
         1.53174751e-05, 0.329103112], [0.000713374931, 1.79615326e-05, 0.328000665],
         [0.000609062205, 2.04427743e-05, 0.326856583], [0.000506209559, 2.2741744e-05,
         0.325668216], [0.000406768086, 2.48464676e-05, 0.324433655], [0.000312358112,
         2.676851e-05, 0.323151261], [0.000223872252, 2.85416645e-05, 0.321819812],
         [0.000142058911, 3.01844429e-05, 0.320438683], [6.75892879e-05, 3.16541154e-05,
         0.319007903], [1.2558628e-06, 3.29556715e-05, 0.317528248]],
    3.0: [[2.44286894e-05, 3.04919396e-08, 0.349947184], [8.33571539e-05, 1.66799783e-08,
         0.34981057], [0.000162991855, -5.8013466e-08, 0.349600226], [0.000257266802,
         -2.06467078e-07, 0.34931761], [0.000364647683, -4.09600915e-07, 0.348963529],
         [0.000486021134, -7.66016342e-07, 0.348542243], [0.000622999272, -1.33728918e-06,
         0.348057836], [0.000772504776, -2.00953605e-06, 0.347514659], [0.000926824985,
         -2.71541921e-06, 0.346918613], [0.00107744802, -3.54299732e-06, 0.346278429],
         [0.00121352135, -4.38381403e-06, 0.345601618], [0.00132608227, -4.98933605e-06,
         0.344896227], [0.00141396653, -5.11868166e-06, 0.344187975], [0.00147498737,
         -4.52505583e-06, 0.343493104], [0.00150471774, -3.01457135e-06, 0.34281072],
         [0.00149796891, -6.0377107e-07, 0.342139959], [0.00145086413, 2.46994978e-06,
         0.341478109], [0.00136673707, 5.98009956e-06, 0.34081912], [0.00124750182, 9.9763829e-06,
         0.340159118], [0.00109842361, 1.42231956e-05, 0.339483947], [0.000930912676,
         1.85208082e-05, 0.338782072], [0.000753671804, 2.203445e-05, 0.338044077],
         [0.000576565741, 2.497901e-05, 0.337267607], [0.000406736275, 2.78914704e-05,
         0.336453587], [0.000248288503, 3.06608381e-05, 0.335601002], [0.000106330852,
         3.33941098e-05, 0.334709972], [-1.5626887e-05, 3.59429905e-05, 0.333772659],
         [-0.000116766154, 3.81318605e-05, 0.332783073], [-0.000197321031, 3.99571654e-05,
         0.331742108], [-0.000257793319, 4.14634196e-05, 0.330652058], [-0.000298852159,
         4.26980187e-05, 0.329516053], [-0.000321528467, 4.37427188e-05, 0.328336209],
         [-0.000332162628, 4.49041363e-05, 0.327108651], [-0.000322603213, 4.60263509e-05,
         0.325829566], [-0.000290203607, 4.69687257e-05, 0.324503541], [-0.000242375943,
         4.79320806e-05, 0.323130995], [-0.000182148637, 4.90863749e-05, 0.321706742],
         [-0.000110699439, 5.05385397e-05, 0.320225656], [-2.99513231e-05, 5.24276038e-05,
         0.318683624], [6.17088663e-05, 5.45714975e-05, 0.317079574]],
    4.0: [[3.65236701e-05, 1.94875213e-07, 0.349932134], [0.000137892363, 3.59516036e-07,
         0.349750191], [0.000294291502, 3.82500446e-07, 0.349466413], [0.000483024312,
         3.89525837e-07, 0.349099129], [0.00068812212, 1.84835741e-07, 0.348664522],
         [0.000894428231, -1.16022704e-07, 0.348175436], [0.00108594412, -2.0597011e-07,
         0.347642988], [0.00125514902, 6.76456509e-08, 0.347076178], [0.0014000606, 9.29644443e-07,
         0.346488863], [0.00151844416, 2.55885266e-06, 0.345902085], [0.00160532317,
         5.01691056e-06, 0.345326573], [0.00165894022, 7.4147847e-06, 0.344760835], [0.00167405896,
         1.02297072e-05, 0.34420529], [0.00164526945, 1.37956122e-05, 0.343660295], [0.00157391152,
         1.78037117e-05, 0.343123257], [0.00146129692, 2.21423288e-05, 0.342582136],
         [0.00131058693, 2.65682629e-05, 0.342023522], [0.00113776478, 3.0762847e-05, 0.34143579],
         [0.000961385143, 3.44167674e-05, 0.340813935], [0.000790046295, 3.74597621e-05,
         0.340158045], [0.000628670678, 3.97348194e-05, 0.33946836], [0.000479761715,
         4.16504154e-05, 0.338739604], [0.000342917454, 4.32071465e-05, 0.337963909],
         [0.000217300287, 4.41248048e-05, 0.337137789], [0.000105098872, 4.49832223e-05,
         0.336249202], [6.78567176e-06, 4.56339149e-05, 0.335306704], [-7.52514825e-05,
         4.60394222e-05, 0.334316909], [-0.000141100929, 4.68264516e-05, 0.333277822],
         [-0.000180405419, 4.80891395e-05, 0.332174391], [-0.000185817349, 5.0009683e-05,
         0.331000268], [-0.0001552795, 5.33051461e-05, 0.329766124], [-8.42426962e-05,
         5.81469831e-05, 0.328472823], [2.64915288e-05, 6.43357635e-05, 0.327114254],
         [0.000170874788, 7.15536517e-05, 0.3256917], [0.000339555554, 7.95460801e-05,
         0.324216932], [0.000525734562, 8.78449282e-05, 0.322703302], [0.00071336003,
         9.55409196e-05, 0.32115981], [0.000887723931, 0.000101637066, 0.319593072],
         [0.00105138822, 0.000105341831, 0.318024069], [0.00120874355, 0.000105864558,
         0.316464126]],
    5.0: [[3.97856275e-05, 2.80101119e-07, 0.349925548], [0.000147819635, 1.10697169e-06,
         0.349729061], [0.00032031216, 1.68183738e-06, 0.349422455], [0.000533200975,
         1.61628327e-06, 0.349025577], [0.000759899325, 1.46585592e-06, 0.348560423],
         [0.000982027967, 1.48163474e-06, 0.348042995], [0.00118985039, 1.53695305e-06,
         0.347482234], [0.00138116721, 2.06471327e-06, 0.346880585], [0.00155182066,
         3.97096937e-06, 0.346256644], [0.00169516588, 7.48557841e-06, 0.345634043],
         [0.00180592842, 1.23316704e-05, 0.345020086], [0.00187842874, 1.84512282e-05,
         0.344415814], [0.00190610311, 2.5495905e-05, 0.343825191], [0.00188655255, 3.28441383e-05,
         0.343246132], [0.00181917264, 4.04920793e-05, 0.342677474], [0.0017085555, 4.75636334e-05,
         0.34210819], [0.00155703793, 5.37913584e-05, 0.341523767], [0.00136697933, 5.91804055e-05,
         0.340916038], [0.00115539064, 6.37560661e-05, 0.340279281], [0.000941279926,
         6.73832546e-05, 0.339609027], [0.000737199094, 7.01150857e-05, 0.338906378],
         [0.000548351672, 7.22409313e-05, 0.338175297], [0.000372912851, 7.36723014e-05,
         0.337407649], [0.000208795696, 7.43787896e-05, 0.336592615], [6.2033796e-05,
         7.47759914e-05, 0.335716248], [-6.58001154e-05, 7.49597457e-05, 0.334786415],
         [-0.000172144602, 7.51627813e-05, 0.333810776], [-0.00025400109, 7.59828399e-05,
         0.332787484], [-0.000308312709, 7.73401116e-05, 0.33170259], [-0.000329814211,
         7.950898e-05, 0.330548376], [-0.000313490222, 8.26954783e-05, 0.329329222],
         [-0.000256004743, 8.70488293e-05, 0.328045696], [-0.000162048105, 9.26968205e-05,
         0.326703727], [-2.9785042e-05, 9.95647351e-05, 0.325305253], [0.000135709357,
         0.000106885527, 0.323853463], [0.000314408593, 0.000113744078, 0.322366774],
         [0.000498610607, 0.000119754965, 0.320863336], [0.000681936624, 0.00012349413,
         0.319345444], [0.000859872613, 0.000125290069, 0.31782195], [0.00103827019,
         0.000123817314, 0.316301942]]}
# bases within 2e-3 of the JAX lanes loop over the first 15 steps (a T = 0.20 s gait puts a
# phase boundary on a knot of the h16 horizon from step 35, a T = 0.14 s one from step 20:
# there XLA and eager PyTorch may round the float32 clock to either side); the speed within
# max(0.1 m/s, 2 x JAX's nudge spread) of both JAX loops; falls equal to the lanes loop's
WB_BASE_ROWS, WB_BASE_ATOL, WB_V_TOL = 15, 2e-3, 0.1
# (c) analysis.parity.mpc_vs_bp5 at cmd 1 on ARTIFACT (warmup 200, MPCConfig(horizon=50): 8
# iterations, forward-mode AD Jacobians), the JAX package's on the CPU, produced by
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wb_loop.py parity
# mae, torque_mae, the solve's warm-start and final cost; the state it solves from ([gc; gv]
# of its policy rollout at step 199); how far mae, torque_mae and the final cost (relative)
# move when that start is 1e-6 m higher or lower. Held: the port's warm start from JAX's start
# within WB_WARM_RTOL of JAX's (phase 13's limit: one rollout, no step decision), and the
# port's mae and torque_mae end to end within max(5e-3, 2 x JAX's spread) of JAX's. The final
# cost from JAX's start is recorded against JAX's and held by no limit: the nudge moves JAX's
# own final cost by 50 % and the port's on the CPU from 100.3 to 441.5 (the same command), so
# no limit on it separates a right port from a wrong one (phase 13's finding for the lanes
# solves); the solve is held to descend from its warm start.
JAX_MPC_VS_BP5 = {"mae": 0.1751755326986313, "torque_mae": 0.3083701729774475,
                  "warm_cost": 594.1945190429688, "cost": 115.56867218017578}
JAX_MPC_VS_BP5_X0 = [0.181168109, 0.000889111194, 0.281368375, 0.999906838, -0.00684671476,
                     -0.00765947811, -0.00899370201, 0.0741564706, -0.990990222, 1.70796013,
                     -0.163991943, -0.573399127, 1.73296869, 0.143116325, -0.579201579, 1.74227667,
                     -0.137911394, -0.842408717, 1.80709457, 0.93881917, -0.0495576598,
                     0.0410154872, -0.275415391, 0.403025389, -0.0532041639, 0.813388884,
                     -2.41451144, -0.142152578, 0.270096987, 0.592089236, -3.0987134, 0.484328151,
                     -1.18928719, -0.174977586, 0.365025848, -3.35896325, -0.286406189]
JAX_MPC_VS_BP5_SPREAD = {"mae": 0.045736998319625854, "torque_mae": 0.09462776780128479,
                         "cost": 0.5019299480578621}
MPC_VS_BP5_ATOL = 5e-3
# (d) a short terrain_model=True loop at wb_speed_schedule(cmd 1) on the sampled heightmap
# (z_scale 0.05) at JAX's map offset (env_init(cfg, PRNGKey(0))): finite and upright (base
# height within 0.2-0.5 m, no fall); its bases against the JAX lanes loop's are recorded.
# 15 steps (25 before phase 18 came): the time limit
WB_TERRAIN_STEPS, WB_TERRAIN_Z = 15, 0.05
JAX_WB_TERRAIN = {"offset": [52.9175262, 5.82514], "falls": 0, "bases": [[1.26778523e-05,
                  -1.75386923e-08, 0.320445597], [3.82015169e-05, -3.60429766e-08, 0.320357114],
                  [6.85919949e-05, -4.95923658e-08, 0.32022047], [0.000102742248, -7.4558379e-08,
                  0.320035815], [0.000140785269, -1.20819934e-07, 0.319802225], [0.00018303949,
                  -1.96697684e-07, 0.319518566], [0.000229770085, -3.11751819e-07, 0.319183797],
                  [0.00028110118, -4.77615231e-07, 0.318797082], [0.000336961064, -7.07868992e-07,
                  0.318357915], [0.000397039606, -1.01718047e-06, 0.317866206], [0.000460762851,
                  -1.41972089e-06, 0.317322582], [0.000527284981, -1.92703305e-06, 0.316728294],
                  [0.000595496676, -2.54441079e-06, 0.316085368], [0.000664066232, -3.26803274e-06,
                  0.315396756], [0.000731494336, -4.08177266e-06, 0.314666003], [0.000796187902,
                  -4.95495669e-06, 0.31389758], [0.000856536615, -5.84189729e-06, 0.313096315],
                  [0.000910996052, -6.68390658e-06, 0.312267393], [0.000958158984, -7.41403073e-06,
                  0.311415941], [0.000996811199, -7.96410586e-06, 0.310546637], [0.00102597743,
                  -8.27338226e-06, 0.309663475], [0.00104495161, -8.29681085e-06, 0.308769345],
                  [0.00105331501, -8.01133592e-06, 0.307866067], [0.00105094758, -7.41878512e-06,
                  0.306953937], [0.00103802967, -6.54481209e-06, 0.306031972]]}

# phase 15: the per-env control step (envs.blackpanther.step: the dense per-env physics, plain
# PyTorch, no physics launch). Every limit below was fixed before the phase's first run on the
# H100. (a) and (b) follow scripts/hard_contact_eval.py: the flagship under test_default() with
# terrain off, cmd 1-5 as one batch of analysis.eval.policy_rollout for PERENV_STEPS steps, (a)
# with hard contact, (b) with the meteorite attacks on compliant contact; held to the JAX
# package's analysis.eval under the same config on the CPU at the same length, produced by
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_perenv.py refs <PERENV_STEPS>
# per command: the trailing-40 % forward speed, the falls, the largest move of the speed when
# the start is 1e-6 m higher or lower (nudge_spread) and the bases (gc[:3]) over the first
# PERENV_BASE_ROWS steps. Held: bases within PERENV_BASE_ATOL, the speed within max(0.1 m/s,
# 2 x the nudge spread) (phase 14's limits), falls equal, no physics launch and 2 LSTM pair
# launches a step. N = 200 where the script takes 2000, cut to fit the time limit: a probe of
# this phase alone (NVIDIA H100 80GB HBM3, 700 W; PERF.md) took 162 / 74 ms a step for (a) / (b),
# twice that beside the other phases on a slow host.
PERENV_STEPS = 200
PERENV_BASE_ROWS, PERENV_BASE_ATOL, PERENV_V_TOL = 15, 2e-3, 0.1
PERENV_COMMANDS = (1.0, 2.0, 3.0, 4.0, 5.0)
JAX_PERENV = {
    "hard": {
        1.0: {"v": 0.8071326017379761, "falls": 0, "nudge_spread": 5.424022674560547e-06,
            "bases": [[6.53190091e-06, -2.18788728e-07, 0.34999463], [2.12356099e-05,
            -2.01056309e-06, 0.349975556], [3.917305e-05, -5.7732077e-06, 0.34993282],
            [5.73094803e-05, -1.05709087e-05, 0.349856228], [7.51400803e-05, -1.56018759e-05,
            0.349740714], [9.38089142e-05, -2.04953831e-05, 0.349584609], [0.000114844021,
            -2.51595302e-05, 0.349386841], [0.000139272757, -2.9585879e-05, 0.349145383],
            [0.00016737025, -3.37478996e-05, 0.34885776], [0.000198844675, -3.75860945e-05,
            0.348521709], [0.00023313571, -4.10287357e-05, 0.348136008], [0.000269623823,
            -4.40137119e-05, 0.347700268], [0.000307708164, -4.65017074e-05, 0.347215116],
            [0.000346794695, -4.84826523e-05, 0.346681476], [0.000386251952, -4.99784583e-05,
            0.346100777]]},
        2.0: {"v": 1.2649306058883667, "falls": 0, "nudge_spread": 0.00017976760864257812,
            "bases": [[8.38569576e-06, -1.16943681e-06, 0.349992037], [2.84213638e-05,
            -5.11430881e-06, 0.349965006], [5.44193135e-05, -1.1880592e-05, 0.349908531],
            [8.16068059e-05, -2.03770123e-05, 0.349813014], [0.00010813713, -2.9509245e-05,
            0.349674195], [0.000134677117, -3.85420426e-05, 0.34949103], [0.000162943717,
            -4.70730702e-05, 0.349262655], [0.000194440552, -5.48925018e-05, 0.348987103],
            [0.000229934798, -6.18753329e-05, 0.348661929], [0.000269524084, -6.79349178e-05,
            0.348285228], [0.000312900112, -7.30125103e-05, 0.347856313], [0.000359545753,
            -7.70797051e-05, 0.347375631], [0.000408810214, -8.01431088e-05, 0.346844584],
            [0.000459914474, -8.22481379e-05, 0.346265078], [0.000511944701, -8.34800812e-05,
            0.345639348]]},
        3.0: {"v": 1.3052444458007812, "falls": 0, "nudge_spread": 0.004602193832397461,
            "bases": [[1.02790418e-05, -2.12980876e-06, 0.349989355], [3.58525176e-05,
            -8.26256655e-06, 0.349954635], [7.03550977e-05, -1.80435964e-05, 0.349885911],
            [0.000107183048, -3.02076805e-05, 0.349774927], [0.000142978068, -4.3447355e-05,
            0.349618077], [0.000177802154, -5.67634197e-05, 0.349414051], [0.000213524487,
            -6.95047274e-05, 0.349161357], [0.000252173049, -8.12718717e-05, 0.348857611],
            [0.00029509567, -9.18136357e-05, 0.348500252], [0.000342854444, -0.000100961646,
            0.348087728], [0.000395428389, -0.000108602559, 0.347619921], [0.00045241366,
            -0.000114674498, 0.347098023], [0.000513132487, -0.000119173987, 0.346524268],
            [0.000576683786, -0.000122162382, 0.345901489], [0.000641973282, -0.000123764708,
            0.345233113]]},
        4.0: {"v": 1.1890124082565308, "falls": 0, "nudge_spread": 0.002263188362121582,
            "bases": [[1.21965468e-05, -3.11676126e-06, 0.349986792], [4.34297035e-05,
            -1.1578978e-05, 0.34994483], [8.67140625e-05, -2.46079071e-05, 0.349865556],
            [0.000133596375, -4.06740801e-05, 0.349743068], [0.000179151437, -5.82766806e-05,
            0.349574506], [0.000222795832, -7.62769778e-05, 0.349357665], [0.000266527612,
            -9.39155871e-05, 0.349089503], [0.000312878954, -0.000110687281, 0.348766387],
            [0.000363746134, -0.000126215484, 0.348385096], [0.000420107972, -0.00014018103,
            0.34794414], [0.000482191099, -0.000152307461, 0.347443998], [0.000549714139,
            -0.000162381912, 0.346886665], [0.000622060092, -0.000170285522, 0.34627521],
            [0.000698365096, -0.000176015164, 0.345613629], [0.000777548295, -0.000179683717,
            0.34490639]]},
        5.0: {"v": 1.0112911462783813, "falls": 0, "nudge_spread": 0.001634836196899414,
            "bases": [[1.41833525e-05, -4.14430315e-06, 0.349984199], [5.13216328e-05,
            -1.515638e-05, 0.349935174], [0.000103863669, -3.18868588e-05, 0.349846244],
            [0.000161480319, -5.24689567e-05, 0.349714726], [0.000217615961, -7.51408734e-05,
            0.349539101], [0.000271001743, -9.86361483e-05, 0.349316239], [0.00032376076,
            -0.000122187223, 0.349040836], [0.000378937257, -0.000145306243, 0.348706931],
            [0.000438950694, -0.000167553575, 0.348310024], [0.00050511508, -0.000188425081,
            0.347848296], [0.000577838975, -0.000207343328, 0.347322732], [0.000657105236,
            -0.00022367631, 0.346736878], [0.000742539123, -0.000236982232, 0.346095473],
            [0.000833352504, -0.000247140415, 0.34540379], [0.000928451482, -0.000254269544,
            0.344667464]]},
    },
    "crucial": {
        1.0: {"v": 0.49996739625930786, "falls": 0, "nudge_spread": 1.2218952178955078e-06,
            "bases": [[6.53190091e-06, -2.18788728e-07, 0.34999463], [2.12356099e-05,
            -2.01056309e-06, 0.349975556], [3.917305e-05, -5.7732077e-06, 0.34993282],
            [5.73094803e-05, -1.05709087e-05, 0.349856228], [7.51400803e-05, -1.56018759e-05,
            0.349740714], [9.38089142e-05, -2.04953831e-05, 0.349584609], [0.000114844021,
            -2.51595302e-05, 0.349386841], [0.000139272757, -2.9585879e-05, 0.349145383],
            [0.00016737025, -3.37478996e-05, 0.34885776], [0.000198844675, -3.75860945e-05,
            0.348521709], [0.00023313571, -4.10287357e-05, 0.348136008], [0.000269623823,
            -4.40137119e-05, 0.347700268], [0.000307708164, -4.65017074e-05, 0.347215116],
            [0.000346794695, -4.84826523e-05, 0.346681476], [0.000386251952, -4.99784583e-05,
            0.346100777]]},
        2.0: {"v": 1.069435715675354, "falls": 0, "nudge_spread": 3.5762786865234375e-06,
            "bases": [[8.38569576e-06, -1.16943681e-06, 0.349992037], [2.84213638e-05,
            -5.11430881e-06, 0.349965006], [5.44193135e-05, -1.1880592e-05, 0.349908531],
            [8.16068059e-05, -2.03770123e-05, 0.349813014], [0.00010813713, -2.9509245e-05,
            0.349674195], [0.000134677117, -3.85420426e-05, 0.34949103], [0.000162943717,
            -4.70730702e-05, 0.349262655], [0.000194440552, -5.48925018e-05, 0.348987103],
            [0.000229934798, -6.18753329e-05, 0.348661929], [0.000269524084, -6.79349178e-05,
            0.348285228], [0.000312900112, -7.30125103e-05, 0.347856313], [0.000359545753,
            -7.70797051e-05, 0.347375631], [0.000408810214, -8.01431088e-05, 0.346844584],
            [0.000459914474, -8.22481379e-05, 0.346265078], [0.000511944701, -8.34800812e-05,
            0.345639348]]},
        3.0: {"v": 1.1976121664047241, "falls": 0, "nudge_spread": 4.0531158447265625e-06,
            "bases": [[1.02790418e-05, -2.12980876e-06, 0.349989355], [3.58525176e-05,
            -8.26256655e-06, 0.349954635], [7.03550977e-05, -1.80435964e-05, 0.349885911],
            [0.000107183048, -3.02076805e-05, 0.349774927], [0.000142978068, -4.34473586e-05,
            0.349618077], [0.000177802154, -5.67634233e-05, 0.349414051], [0.000213524487,
            -6.95047347e-05, 0.349161357], [0.000252173049, -8.1271879e-05, 0.348857611],
            [0.00029509567, -9.18136429e-05, 0.348500252], [0.000342854444, -0.000100961661,
            0.348087728], [0.000395428389, -0.000108602573, 0.347619921], [0.00045241366,
            -0.000114674513, 0.347098023], [0.000513132487, -0.000119174001, 0.346524268],
            [0.000576683786, -0.000122162397, 0.345901489], [0.000641973282, -0.000123764738,
            0.345233113]]},
        4.0: {"v": 1.2379262447357178, "falls": 0, "nudge_spread": 5.841255187988281e-06,
            "bases": [[1.21965468e-05, -3.11676126e-06, 0.349986792], [4.34297035e-05,
            -1.1578978e-05, 0.34994483], [8.67140625e-05, -2.46079071e-05, 0.349865556],
            [0.000133596375, -4.06740801e-05, 0.349743068], [0.000179151437, -5.82766806e-05,
            0.349574506], [0.000222795832, -7.62769778e-05, 0.349357665], [0.000266527612,
            -9.39155871e-05, 0.349089503], [0.000312878954, -0.000110687281, 0.348766387],
            [0.000363746134, -0.000126215484, 0.348385096], [0.000420107972, -0.00014018103,
            0.34794414], [0.000482191099, -0.000152307461, 0.347443998], [0.000549714139,
            -0.000162381912, 0.346886665], [0.000622060092, -0.000170285522, 0.34627521],
            [0.000698365096, -0.000176015164, 0.345613629], [0.000777548295, -0.000179683717,
            0.34490639]]},
        5.0: {"v": 1.138012170791626, "falls": 0, "nudge_spread": 6.079673767089844e-06,
            "bases": [[1.41833525e-05, -4.14430315e-06, 0.349984199], [5.13216328e-05,
            -1.515638e-05, 0.349935174], [0.000103863669, -3.18868588e-05, 0.349846244],
            [0.000161480319, -5.24689567e-05, 0.349714726], [0.000217615961, -7.51408734e-05,
            0.349539101], [0.000271001743, -9.86361483e-05, 0.349316239], [0.00032376076,
            -0.000122187223, 0.349040836], [0.000378937257, -0.000145306243, 0.348706931],
            [0.000438950694, -0.000167553575, 0.348310024], [0.00050511508, -0.000188425081,
            0.347848296], [0.000577838975, -0.000207343328, 0.347322732], [0.000657105236,
            -0.00022367631, 0.346736878], [0.000742539123, -0.000236982232, 0.346095473],
            [0.000833352504, -0.000247140415, 0.34540379], [0.000928451482, -0.000254269544,
            0.344667464]]},
    },
}
# (c) cli.train --cfg configs/bp5_train.yaml (200 envs: the per-env path by the JAX package's
# rule) --load ARTIFACT --lr 5e-4: PERENV_TRAIN_UPDATES updates of PERENV_TRAIN_STEPS steps (the
# YAML's 750 cut) and 10 epochs; then one update of PERENV_VARIANT_STEPS steps on a copy of the
# YAML with HardContact and Crutial set. (d) PPO3 over NumpyVecEnv at the YAML's 200 envs for
# PPO3_STEPS steps and one learn, with the flagship's LSTM; then one PPO3 learn and one
# ppo.learn update with MlpPolicy. (e) step against step_batch at 200 and 1024 envs, recorded.
PERENV_B = 200
PERENV_TRAIN_UPDATES, PERENV_TRAIN_STEPS, PERENV_VARIANT_STEPS = 2, 40, 20
PPO3_STEPS = 30
PERENV_TIMING_STEPS = 3
PERENV_LOG_DIR = os.path.join(ROOT, "runs", "chip_smoke_perenv")

# the per-row LSTM kernel (lstm_cell_pair_rows_kernel) at the landscape's batches: 1326 blends
# at JAX's default step 0.02, 5151 at the reference total_reward.txt's step 0.01
ROWS_B = (1326, 5151)
# phase 16: the rest of cli/test.py. Every limit below was fixed before the phase's first run
# on the H100.
# (a) the reward landscape: the three 2xLSTM(48) anchors at 2 m/s, step 0.01 (5151 blends, one
# batch), 750 steps; its 15 blends of step 0.25 (rows of the 0.01 grid, bit for bit) held to
# JAX's _landscape_batch on the CPU (`tests/test_torch_landscape.py refs`): alive_len equal,
# each accumulated term within max(LANDSCAPE_RTOL |JAX|, 2 x JAX's 1e-6 m nudge spread) +
# LANDSCAPE_ATOL (the CPU test's 2e-3 relative at 30 steps; the spread is at most 1.1e-3
# relative); the per-row kernel against its plain twin over the first LANDSCAPE_TWIN_STEPS
# steps, both fed the kernel's trajectory (one step of the cell from the same inputs)
LANDSCAPE_ANCHORS = [os.path.join(ROOT, "artifacts", a) for a in
                     ("irrl_tpu_imitation", "irrl_tpu_relaxed", "irrl_tpu_relaxed_4e8")]
LANDSCAPE_STEP, LANDSCAPE_CHECK_STEP, LANDSCAPE_STEPS, LANDSCAPE_VX = 0.01, 0.25, 750, 2.0
LANDSCAPE_TWIN_STEPS, LANDSCAPE_TWIN_ATOL = 50, 1e-4
LANDSCAPE_RTOL, LANDSCAPE_ATOL = 2e-3, 1e-3
LANDSCAPE_PROF_STEPS = 10
# (b) --kappa-entropy at cmd 1, 3, 5, 4096 episodes (recorded)
# 100 steps (500 before phase 18 came): the time limit
ENTROPY_COMMANDS, ENTROPY_EPISODES, ENTROPY_STEPS = "1,3,5", 4096, 100
# (c) --kappa at cmd 1-5, kick 1 m/s, 1500 steps (the five rows one batch): kappa within
# max(KAPPA_TOL, 2 x JAX's nudge spread) of JAX's recovery_sweep on the CPU
# (`tests/test_torch_robustness.py kappa`), survival equal
KAPPA_STEPS, KAPPA_TOL = 1500, 0.25
# (d) one cli.test call with the single-rollout modes at vx 2 [300 steps of the CLI's 750], then
# value_pca, spectrogram and toe_trajectories on a rollout, and --teleop --serve for 200 steps
CLI_STEPS, TELEOP_STEPS = 300, 200
CLI_OUT_DIR = os.path.join(ROOT, "runs", "chip_smoke_cli")
JAX_LANDSCAPE = {
    "alive_len": [750, 750, 750, 750, 750, 750, 750, 750, 750, 750, 750, 750, 750, 750, 750],
    "alive_nudge_spread": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "terms": [
        [0.0, 145.889023, 129.365982, 1.57447844e-09, 86.9301147, 115.307068, 55.9827385, 13.4370613],
        [0.0, 146.116394, 106.061348, 3.88890781e-10, 117.031616, 73.1642456, 59.543438, 1.82656217],
        [0.0, 147.056595, 93.274147, 1.36620548e-10, 134.751633, 59.12677, 58.8694038, 1.64589071],
        [0.0, 147.534775, 121.092926, 8.78384795e-11, 128.64328, 49.7518921, 56.591629, 0.76142931],
        [0.0, 145.146118, 76.6964874, 9.34765945e-11, 107.452774, 40.8931389, 54.5287247, 0.220627233],
        [0.0, 146.271378, 109.589127, 3.45772161e-10, 117.631805, 69.6138229, 59.5401688, 2.24536824],
        [0.0, 147.163269, 100.209061, 1.2233882e-10, 133.718002, 57.4250679, 59.1108742, 1.87527585],
        [0.0, 147.658798, 124.433479, 8.41825429e-11, 126.527374, 48.1391106, 56.5825157, 0.764269054],
        [0.0, 144.272629, 76.9721909, 1.08406388e-10, 104.538742, 40.0132561, 54.4206963, 0.0736674145],
        [0.0, 147.244217, 105.84314, 1.14800905e-10, 132.112396, 52.7742958, 58.7774315, 1.98778415],
        [0.0, 147.768387, 126.600563, 8.30512811e-11, 124.143555, 46.1854858, 56.567028, 0.905103385],
        [0.0, 143.586655, 78.4788284, 1.24223021e-10, 101.643364, 38.4002571, 54.4057465, 0.0501897931],
        [0.0, 147.875031, 127.723167, 8.33722535e-11, 121.321602, 42.9776115, 56.6555977, 0.879066467],
        [0.0, 143.030533, 80.5628662, 1.41789552e-10, 98.8184586, 37.5658264, 54.2377853, 0.0479868464],
        [0.0, 142.317886, 81.4967728, 1.64845637e-10, 96.9759216, 34.7900925, 54.21101, 0.0490335152],
    ],
    "terms_nudge_spread": [[0.0, 7.63e-05, 0.000198, 8.08e-14, 4.58e-05, 2.29e-05, 3.43e-05, 7.63e-06],
        [0.0, 6.1e-05, 7.63e-05, 1.3e-14, 7.63e-06, 1.53e-05, 1.14e-05, 2.74e-06],
        [0.0, 0.000305, 0.016, 8.13e-15, 0.000137, 0.000572, 0.00118, 9.06e-05],
        [0.0, 0.000168, 0.00169, 1.69e-15, 1.53e-05, 0.00037, 0.000156, 1.73e-05],
        [0.0, 0.000137, 0.0019, 2.88e-15, 0.000648, 0.000629, 8.39e-05, 3.64e-06],
        [0.0, 9.16e-05, 3.05e-05, 1.27e-14, 2.29e-05, 1.53e-05, 3.81e-06, 1.67e-06],
        [0.0, 7.63e-05, 0.000107, 3.82e-15, 1.53e-05, 1.53e-05, 1.53e-05, 7.51e-06],
        [0.0, 6.1e-05, 7.63e-05, 1.78e-15, 2.29e-05, 9.16e-05, 1.14e-05, 1.08e-05],
        [0.0, 0.000198, 0.00175, 3.32e-15, 0.000534, 0.000401, 0.00013, 2.5e-06],
        [0.0, 9.16e-05, 6.87e-05, 2.9e-15, 1.53e-05, 1.53e-05, 7.63e-06, 8.34e-06],
        [0.0, 6.1e-05, 0.000122, 1.66e-15, 3.05e-05, 8.39e-05, 7.63e-06, 9.36e-06],
        [0.0, 0.000183, 0.00163, 3.44e-15, 0.000534, 0.000477, 5.34e-05, 3.5e-07],
        [0.0, 6.1e-05, 0.000183, 1.62e-15, 1.53e-05, 8.39e-05, 7.63e-06, 1.22e-05],
        [0.0, 0.000992, 0.0148, 7.79e-14, 0.0146, 0.0167, 0.0241, 4.56e-05],
        [0.0, 0.000183, 0.000931, 5.55e-15, 0.000427, 0.000317, 4.58e-05, 1.33e-06]]}
JAX_KAPPA = {1.0: {"kappa": -6.0674382, "survived": False, "nudge_spread": 6.61e-06},
             2.0: {"kappa": -3.52340557, "survived": False, "nudge_spread": 1.47e-05},
             3.0: {"kappa": -5.87886119, "survived": True, "nudge_spread": 0.000138},
             4.0: {"kappa": -3.13779692, "survived": True, "nudge_spread": 0.0113},
             5.0: {"kappa": -2.97878315, "survived": True, "nudge_spread": 0.00039}}

# phase 17: RefTraj tables, the analytic fractal terrain, the tooling closures. Every limit below
# was fixed before the phase's first run on the H100.
# (a) the flagship through step_batch with a table synthesized from the gait generator (cmd 1-5,
# REFTRAJ_FRAMES frames each) at 1024 envs for REFTRAJ_STEPS steps, ManualTraj off: every env's
# joint_ref, joint_dot_ref, command_filtered and phase observation equal to its table row at
# every step, 1 physics and 2 LSTM pair launches a step
REFTRAJ_FRAMES, REFTRAJ_STEPS = 600, 200
# (b) the analytic terrain (configs/bp5_relax_terrain.yaml with terrain_sampled off): the
# kernel's analytic instantiation against its plain twin (replayed from a CUDA graph) over
# ANALYTIC_TWIN_STEPS control steps at 1024 envs from the envs' spawn (PD to the stand pose;
# the toes land at ~35 steps), bases within TERRAIN_BASE_ATOL at every step; then the terrain
# policy at cmd 1-3 x the 8 seeds of JAX's env_init(cfg, PRNGKey(k)), k < 8, one batch of 24
# envs for TERRAIN_STEPS steps on step_batch, against the JAX lanes loop on the CPU
# (`tests/test_torch_terrain_analytic.py lanes 1500`): per command the mean over the seeds of
# the trailing-40 % forward speed within max(V_TOL, 2 x JAX's spread under a 1e-6 m nudge of
# the start), the falls within JAX's range under that nudge. The hash's float32 sin flips
# (under 1 % of points, up to 0.2 m) are real terrain differences: no limit on bases or falls
# equal to JAX's, as phase 10 has on the heightmap.
ANALYTIC_TWIN_STEPS = 50
# operations of one analytic lookup (csrc/phys_substep.cu ground_height<AnalyticTerrain>):
# seed * 74.7 once; per octave the two scaled coordinates, two floors and fractions, two
# smootherstep (7 each), ix + 1 and iy + 1, 1 - sx and 1 - sy, four hashes (two products, two
# sums, a sine, a product, a floor, a difference, a product and a difference: 10 each), the
# bilinear blend (8 products, 3 sums) and the octave's gain and sum; the scale; p - h
ANALYTIC_LOOKUP_OPS = 1 + 3 * (2 + 2 + 2 + 14 + 2 + 2 + 4 * 10 + 11 + 2) + 1 + 1
JAX_ANALYTIC_SEEDS = [7.293820381164551, 403.6463623046875, 995.6829833984375, 25.994659423828125,
                      637.8344116210938, 83.81330871582031, 192.88540649414062, 675.1336059570312]
JAX_ANALYTIC_LANES = {
    1.0: ([0.7685134410858154, 0.8616187572479248, 0.8706791400909424, 0.866380512714386,
           0.8255972862243652, 0.8034907579421997, 0.8954890966415405, 0.9140418767929077], 0),
    2.0: ([2.2392334938049316, 2.262422561645508, 2.2202060222625732, 2.1480202674865723,
           2.3646886348724365, 2.0955967903137207, 2.150524854660034, 2.221975564956665], 0),
    3.0: ([3.0810632705688477, 3.123487949371338, 3.1910808086395264, 2.930881977081299,
           3.5248775482177734, 3.2125637531280518, 3.0389487743377686, 3.015805721282959], 0)}
# JAX's own spread of the mean speed under the nudge (+-1e-6 m), and its falls in the three runs
JAX_ANALYTIC_NUDGE = {1.0: {"spread": 0.00023111701011657715, "falls": [0, 0, 0]},
                      2.0: {"spread": 0.004114627838134766, "falls": [0, 0, 0]},
                      3.0: {"spread": 0.12471580505371094, "falls": [0, 0, 0]}}
# (c) cli.mpc --viewer: --engine srb for VIEWER_SRB_STEPS steps and --engine wb for
# VIEWER_WB_STEPS at cmd 1, each HTML self-contained with one frame every 5 steps; NumpyVecEnv
# (the per-env step) recording VIDEO_STEPS steps of env 0 to a GIF, one frame every 10
VIEWER_SRB_STEPS, VIEWER_WB_STEPS, VIDEO_STEPS, VIDEO_ENVS = 50, 10, 30, 8
CLOSURES_OUT_DIR = os.path.join(ROOT, "runs", "chip_smoke_closures")
# the host-side figures (the training dashboard, the recorded video) need matplotlib, which not
# every machine with the card has; where it is absent the checks record that they were skipped
HAS_MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None

# phase 4: the policy heads (lstm.row_product against torch.matmul) timed at the widths of
# serving (5 commands), the terrain evaluation (24), full width (1024) and entropy kappa (4096)
HEADS_WIDTHS, HEADS_REPS = (5, 24, 1024, 4096), 500

# phase 18: multi-GPU training and the sharded solves over torch.distributed, on the one card.
# The limits of (a), (b) and the costs and SRB plans of (c) were fixed before the phase's first
# run on the H100; (c)'s others after it, as said there. (a) world 1 over NCCL
# through torch.distributed.run and (b) world 2 over gloo (NCCL refuses two ranks on one
# device), each cli.train --distributed with phase 7's arguments for one update, held to phase
# 7's first update and to each other: every metric within DIST_RTOL relative (DIST_ATOL
# absolute) and every parameter within DIST_RTOL of its leaf's largest entry: JAX's sharded
# against local limit (tests/test_parallel.py:33); the CPU tests' spread of world 2 against
# world 1 is 2.5e-5 relative on the metrics (1.2e-7 absolute on explained_variance) and
# 2.5e-7 of a leaf's largest entry on the parameters (tests/test_torch_distributed.py)
DIST_RTOL, DIST_ATOL = 2e-4, 1e-7
DIST_TIMEOUT_S = 400
# the rollouts' bits compared over blocks of this many envs (the ranks' blocks at world 2)
DIST_BLOCK = FULL_B // 2
# (c) make_distributed_srb at phase 8's problems (world 1 and 2) and make_distributed_mpc at
# DIST_MPC_B problems of phase 13's commands with the fleet's MPC (horizon 16, 2 iterations;
# world 2), against the unsharded solve in the same process: costs within 1e-5 relative
# (tests/test_parallel.py:59-62); the SRB's plans (us) within 1e-5 (the same test) and its
# forces within 1e-5 of their largest entry; the whole-body plans and positions (gc) within
# WB_FLEET_ATOL, the limit of the JAX package's test of a problem in a batch against the same
# problem alone (test_wb_mpc_fleet_batch_matches_single on gc, phase 14a). On the card a
# problem's bits depend on the batch's width: cuBLAS picks its kernels by the batch count (the
# dense model's products in the whole-body linearizer; past 65535 batched products, the SRB
# solve's last chunk), so 1e-5 N on the SRB forces, 1e-5 on the whole-body plans and
# WB_FLEET_ATOL on its velocities all fail on the H100 (PERF.md section 6).
DIST_SOLVE_RTOL, DIST_SOLVE_ATOL = 1e-5, 1e-5
DIST_MPC_B = 64
DIST_LOG_DIR = os.path.join(ROOT, "runs", "chip_smoke_dist")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int, kernel: str | None = None, tries: int = 5,
              warm_up: bool = True) -> float | None:
    """Device time of one call from torch.profiler's CUDA events: the median
    duration of the named kernel's launches, or else all of a call's device
    time, as the mean event times the events a call. The profiler can lose
    events of a window (seen: 4 of 90 to 930 in every window that follows long
    ones in the same process; once about half), and a plain sum then reads
    low: a window that lacks more than 4 events or a tenth of them to a
    whole number a call, or holds no device event at all, is profiled again
    (up to ``tries`` windows); None if none would do. ``warm_up``: one call
    first, where nothing has called ``fn`` just before."""
    if warm_up:
        fn()
        torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = device_events(prof)
        if kernel is not None:
            durs = [(n, d) for n, d in durs if kernel in n]
        if durs and kernel is not None:
            return statistics.median(d for _, d in durs)
        per_call = -(-len(durs) // reps)
        if durs and per_call * reps - len(durs) <= max(4, per_call * reps // 10):
            return statistics.mean(d for _, d in durs) * per_call
    return None


def device_events(prof) -> list[tuple[str, float]]:
    """(name, ms) of every device event of a finished torch.profiler window,
    read from its raw results. ``prof.events()`` builds a Python object and a
    tree over every host and device event first, which for the whole-body
    solves' windows (up to a million events) takes many times as long as
    reading them raw. The names are the raw ones (mangled where the kernel's
    is)."""
    hidden = lambda e: getattr(e, "is_hidden_event", lambda: False)()  # noqa: E731
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA and not hidden(e)]


def _events_ms(fn, keep: bool = False):
    """CUDA events around one call of ``fn`` (-> ms, or (ms, its result))."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return (a.elapsed_time(b), out) if keep else a.elapsed_time(b)


def timings(fn, reps: int = REPS, kernel: str | None = None) -> dict:
    """``ms``: device time (CUDA events where the profiler saw none);
    ``call_ms``: CUDA events around one call, the host's issue time included."""
    call = time_ms(fn, reps)
    dev = device_ms(fn, reps, kernel, warm_up=False)   # time_ms has warmed it up
    return {"ms": call if dev is None else dev, "call_ms": call,
            "source": "events" if dev is None else "profiler"}


class OpCounter(TorchDispatchMode):
    """Arithmetic operations of a plain PyTorch function on its inputs: one
    per output element of each elementwise op, 2mnk per matrix product."""
    ELEMENTWISE = {"add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "sin", "cos", "tanh",
                   "exp", "sigmoid", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
                   "where", "gt", "lt", "ge", "le", "reciprocal", "pow", "abs", "rsub"}

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.calls = 0   # every PyTorch (aten) op issued, views included

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls += 1
        name = func.__name__.split(".")[0].rstrip("_")
        if name in ("mm", "addmm"):
            a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
            self.ops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
            if name == "addmm":
                self.ops += a.shape[0] * b.shape[1]
        elif name in self.ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def count_ops(fn) -> int:
    with OpCounter() as c:
        fn()
    return c.ops


def phys_ops_per_env(n_substeps: int, pd_law: bool, motor_dynamics: bool = False,
                     terrain: bool = False, analytic: bool = False) -> int:
    """Arithmetic operations one env needs for ``n_substeps`` physics substeps,
    each after a PD torque if ``pd_law``: a multiply, an add and a compare
    count one each (a fused multiply-add two), as do a square root, a
    division, a sine, a cosine and a tanh. Counted by hand on the algorithm of
    csrc/phys_substep.cu, with the base body's terms and the 6x6 solve taken
    once an env: composite RNEA and CRBA about the world origin and the
    leg-first solve of the block-arrow mass matrix. (The plain version's
    per-body projections and dense 18x18 Cholesky take some 2.6 times as
    many, which the function does not need.) On ``terrain`` each substep adds
    a lookup under each of the 4 toes and 8 base corners: bilinear on the
    heightmap, or the 3 octaves of value noise of the analytic fractal
    (``analytic``)."""
    cross, dot6 = 9, 11
    si_apply = 2 * cross + 18 + 6          # symmetric 3x3 product, two crosses, m v - h x w
    project = cross + 3
    contact = 24                           # penalty normal force, friction, tangential split
    body = (18                             # world com
            + 105                          # world-origin spatial inertia: R I R^T, m c, shifts
            + 2 * si_apply + 3 * cross + 17)   # I a + v x* I v - gravity
    leg = (43 + 46 + 46                    # three links of FK (sin, cos, Rodrigues, anchor)
           + 6 + 3 * cross                 # toe; motion-subspace columns
           + 3 * (3 * cross + 27)          # velocities and bias accelerations down the leg
           + cross + 3 + contact + cross + 6   # toe velocity, contact, wrench, |f|
           + 2 * (18 + cross + 3 + contact + 2 + cross + 6)   # two of the 8 base corners
           + 3 * (body + 16)               # three bodies, composite inertia and force sums
           + 22 + project                  # the leg's share of the base rows: bias ...
           + 6 * (si_apply + project) + 3 * cross   # ... and its 6x6 block
           + 3 * (dot6 + si_apply + 1 + project) + 6 * dot6   # leg bias, 3x3 block, coupling
           + 20 + 6 * 9 + 18               # 3x3 Cholesky, Y = C L^-T, z = L^-1 r
           + 21 * 8 + 6 * 9                # Schur complement and reduced rhs, summed over legs
           + 3 * 12 + 9                    # back-substitution of the leg's joints
           + 12)                           # joint integration
    base = (39 + 21                        # quaternion to matrix; base velocity, bias acceleration
            + body + 2 * cross             # base body and the base wrench
            + 103 + 36 + 36                # 6x6 Cholesky, forward and backward substitution
            + 18 + 56)                     # base integration, exp-map quaternion update
    pd_joint = (7 + 14 + (22 if motor_dynamics else 0)) if pd_law else 0
    lookup = ANALYTIC_LOOKUP_OPS if analytic else TERRAIN_LOOKUP_OPS
    lookups = TERRAIN_LOOKUPS_PER_ENV * lookup if terrain else 0
    return n_substeps * (4 * leg + base + 12 * pd_joint + lookups)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return max(float((g.detach() - w.detach()).abs().max()) for g, w in zip(got, want))


# --- phase 1 ------------------------------------------------------------------

def phase_environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"devices {torch.cuda.device_count()}, {torch.cuda.get_device_name(0)}")
    return smi


# --- phase 2 ------------------------------------------------------------------

def phase_build() -> dict:
    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    log(f"[2] built {sorted(secs) or 'nothing (cached)'} in {wall:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    ptxas = {}
    for name, out in _build.build_logs.items():
        lines = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        ptxas[name] = lines
        for ln in lines:
            log(f"[2] {name}: {ln}")
    return {"build_s": wall, "per_source_s": secs, "ptxas": ptxas}


# --- phase 3 ------------------------------------------------------------------

def _phys_inputs(B: int, seed: int):
    """Perturbed stand states with per-env randomized params, as the tests'."""
    cfg = config.train_default()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    P = lanes.params_to_lanes(mdl.randomize(gen, cfg, B, DEVICE))
    rng = np.random.default_rng(seed)
    gc = np.tile(mdl.stand_gc(0.0), (B, 1))
    gc[:, 2] = 0.30
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gv = 0.5 * rng.normal(size=(B, 18))
    tau = 5.0 * rng.normal(size=(B, 12))
    bw = np.concatenate([20.0 * rng.normal(size=(B, 3)), rng.normal(size=(B, 3))], -1)
    t = lambda x: torch.tensor(x.T, dtype=torch.float32, device=DEVICE).contiguous()  # noqa: E731
    return P, t(gc), t(gv), t(tau), t(bw)


def _lstm_inputs(B: int, d: int, n: int, seed: int):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=DEVICE)  # noqa: E731
    w = lstm.LSTMWeights(wx=r(d, 4 * n, scale=0.2), wh=r(n, 4 * n, scale=0.2),
                         b=r(4 * n, scale=0.1))
    return w, r(B, d), r(B, n), r(B, n)


def _torch_lstm_cell(w, x, c, h):
    """torch.lstm_cell (PyTorch's own one-call cell, gate order [i, f, g, o])
    on the same weights; a yardstick only, the port never calls it."""
    n = w.wh.shape[0]
    perm = torch.cat([torch.arange(0, 2 * n), torch.arange(3 * n, 4 * n),
                      torch.arange(2 * n, 3 * n)]).to(DEVICE)
    w_ih, w_hh, b = w.wx[:, perm].T.contiguous(), w.wh[:, perm].T.contiguous(), w.b[perm]
    zero = torch.zeros_like(b)
    return lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, b, zero)


def _control_inputs(B: int, seed: int, motor_dynamics: bool):
    """Substep inputs plus position targets around the stand pose, last
    normalized torques, and joint speeds that reach the motor envelope's
    speed-dependent part."""
    P, gc, gv, _, bw = _phys_inputs(B, seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=DEVICE).contiguous()  # noqa: E731
    pt = t(mdl.stand_gc(0.0)[7:, None] + 0.3 * rng.normal(size=(12, B)))
    tnl = t(0.5 * rng.normal(size=(12, B)))
    gv = gv.clone()
    gv[6:] *= 30.0
    pd = pd_torque.from_config(config.test_default().replace(motor_dynamics=motor_dynamics))
    return P, pd, gc, gv, pt, tnl, bw


def _unfused_control_step(P, pd, gcT, gvT, ptT, tnlT, bwT, n, slip, imp, dt):
    """n x {plain PD torque -> single-substep kernel}."""
    for _ in range(n):
        tauT = pd_torque.pd_torque(pd, ptT.T, tnlT.T, gcT[7:].T, gvT[6:].T).T.contiguous()
        gcT, gvT, toe, toe_vel, fnorm, fn = phys_cuda.substep(P, gcT, gvT, tauT, bwT, slip, imp, dt)
    return gcT, gvT, toe, toe_vel, fnorm, fn, tauT


def _convert2torque_inputs(B: int, seed: int, which: str):
    """(tau_ffT, pd_scaleT) as (12, B) rows, or None where ``which`` leaves one
    out: feedforward torques of ~8 Nm and PD scales in [0, 1.5]."""
    rng = np.random.default_rng(seed + 2)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=DEVICE).contiguous()  # noqa: E731
    ff = t(8.0 * rng.normal(size=(12, B))) if which in ("both", "tau_ff") else None
    ps = t(rng.uniform(0.0, 1.5, size=(12, B))) if which in ("both", "pd_scale") else None
    return ff, ps


def _assert_rows(got, want, atols, force_rtol: float) -> float:
    """Row blocks within their tolerances (forces 4, 5 also relative)."""
    for i, atol in enumerate(atols):
        torch.testing.assert_close(got[i], want[i], atol=atol,
                                   rtol=force_rtol if i in (4, 5) else 0)
    return max_err(got, want)


def _check_phys(rec: dict) -> None:
    cfg = config.test_default()
    slip, dt, n_sub = cfg.contact_slip_vel, cfg.simulation_dt, cfg.substeps
    # (a) single substep, the tolerances of the Pallas-vs-lanes test
    errs = []
    for B in (FULL_B, 37, 5):
        for imp in (0.0, 400.0):
            P, gc, gv, tau, bw = _phys_inputs(B, seed=B + int(imp))
            want = lanes.substep(P, gc, gv, tau, bw, slip, imp, dt)
            got = phys_cuda.substep(P, gc, gv, tau, bw, slip, imp, dt)
            torch.cuda.synchronize()
            e = _assert_rows(got, want, SUBSTEP_ATOL, 1e-4)
            errs.append(e)
            log(f"[3] phys_substep B={B} impulse_scale={imp}: matches plain, max |err| {e:.3g}")
    # (b), (c) the fused control step
    fused_errs, step_errs = [], []
    for B in (FULL_B, 37, 5):
        for motor in (False, True):
            args = _control_inputs(B, seed=B + motor, motor_dynamics=motor)
            tail = (n_sub, slip, 0.0, dt)
            got = phys_cuda.control_step(*args, *tail)
            unfused = _unfused_control_step(*args, *tail)
            plain = phys_cuda.control_step_plain(*args, *tail)
            torch.cuda.synchronize()
            eb = _assert_rows(got, unfused, FUSED_ATOL, 1e-4)
            ec = _assert_rows(got, plain, STEP_ATOL, 1e-3)
            rows = lambda ref: ", ".join(  # noqa: E731
                f"{name} {float((g - w).abs().max()):.2g}" for name, g, w in zip(
                    ("gc", "gv", "toe", "toe vel", "|f|", "fn", "torque"), got, ref))
            fused_errs.append(eb)
            step_errs.append(ec)
            log(f"[3] control_step B={B} motor_dynamics={motor} x{n_sub}: vs {n_sub} x (plain "
                f"torque + substep kernel) max |err| {eb:.3g} ({rows(unfused)}); vs plain loop "
                f"{ec:.3g} ({rows(plain)})")

    # (d) the Convert2Torque inputs at the closed loop's impulse scale, against the plain
    # loop at (c)'s tolerances; left out, they are bit for bit a feedforward of 0 and a
    # scale of 1. One plain call a case holds the four choices side by side, an input left
    # out as a block of zeros or ones there (x 1 and + 0 keep the plain loop's bits): the
    # plain loop is ~3 s a call whatever the batch
    imp_mpc = MPC_IMPULSE_MASS / dt
    c2t_errs = []
    choices = ("both", "tau_ff", "pd_scale", "none")
    four = lambda x: torch.cat([x] * len(choices), dim=-1)  # noqa: E731
    for B in (FULL_B, 5, 1):
        for motor in (False, True):
            args = _control_inputs(B, seed=B + 7 + motor, motor_dynamics=motor)
            tail = (n_sub, slip, imp_mpc, dt)
            inputs = [_convert2torque_inputs(B, B + motor, which) for which in choices]
            zeros = torch.zeros(12, B, device=DEVICE)
            plain = phys_cuda.control_step_plain(
                type(args[0])(*map(four, args[0])), args[1], *map(four, args[2:]), *tail,
                torch.cat([zeros if ff is None else ff for ff, _ in inputs], dim=-1),
                torch.cat([zeros + 1.0 if ps is None else ps for _, ps in inputs], dim=-1))
            for k, (which, (ff, ps)) in enumerate(zip(choices, inputs)):
                got = phys_cuda.control_step(*args, *tail, ff, ps)
                torch.cuda.synchronize()
                want = [x[..., k * B:(k + 1) * B] for x in plain]
                c2t_errs.append(_assert_rows(got, want, STEP_ATOL, 1e-3))
                log(f"[3] control_step B={B} motor_dynamics={motor} impulse_scale={imp_mpc:g} "
                    f"inputs={which}: vs plain loop max |err| {c2t_errs[-1]:.3g}")
            omitted = phys_cuda.control_step(*args, *tail)
            given = phys_cuda.control_step(*args, *tail, zeros, zeros + 1.0)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(omitted, given)):
                raise RuntimeError(f"control_step B={B} motor_dynamics={motor}: inputs left out "
                                   "differ from tau_ff = 0, pd_scale = 1")
            log(f"[3] control_step B={B} motor_dynamics={motor}: inputs left out == tau_ff 0, "
                "pd_scale 1, bit for bit")

    P, gc, gv, tau, bw = _phys_inputs(FULL_B, seed=1)
    kt = timings(lambda: phys_cuda.substep(P, gc, gv, tau, bw, slip, 0.0, dt),
                 kernel="phys_substep_kernel")
    pt = timings(lambda: lanes.substep(P, gc, gv, tau, bw, slip, 0.0, dt), reps=3)
    plain_ops = count_ops(lambda: lanes.substep(P, gc, gv, tau, bw, slip, 0.0, dt))
    ops = FULL_B * phys_ops_per_env(1, pd_law=False)
    nbytes = 4 * FULL_B * (phys_cuda.P_ROWS + 19 + 18 + 12 + 6 + phys_cuda.OUT_ROWS)
    b_ms, b_by = bound_ms(nbytes, ops)

    args = _control_inputs(FULL_B, seed=2, motor_dynamics=False)
    tail = (n_sub, slip, 0.0, dt)
    ct = timings(lambda: phys_cuda.control_step(*args, *tail), kernel="phys_control_step_kernel")
    cpt = timings(lambda: phys_cuda.control_step_plain(*args, *tail), reps=1)
    c_plain_ops = count_ops(lambda: phys_cuda.control_step_plain(*args, *tail))
    c_ops = FULL_B * phys_ops_per_env(n_sub, pd_law=True, motor_dynamics=False)
    c_bytes = 4 * FULL_B * (phys_cuda.P_ROWS + 19 + 18 + 12 + 12 + 6 + phys_cuda.STEP_OUT_ROWS)
    cb_ms, cb_by = bound_ms(c_bytes, c_ops)
    # with the Convert2Torque inputs, at the closed loop's impulse scale: 24 more rows read
    # and a multiply and an add more a joint and substep
    ff, ps = _convert2torque_inputs(FULL_B, 3, "both")
    mpc_tail = (n_sub, slip, imp_mpc, dt)
    c2t = timings(lambda: phys_cuda.control_step(*args, *mpc_tail, ff, ps),
                  kernel="phys_control_step_kernel")
    pd_path = timings(lambda: phys_cuda.control_step(*args, *mpc_tail),
                      kernel="phys_control_step_kernel")
    c2t_bytes = c_bytes + 4 * FULL_B * 24
    c2t_ops = c_ops + FULL_B * n_sub * 12 * 2
    c2t_b_ms, c2t_b_by = bound_ms(c2t_bytes, c2t_ops)
    # ms, plain_ms, bound_ms and max_abs_err read the fused control step, the entry point
    # the main path launches; the single substep stands beside it under substep_*
    rec["phys_substep"] = dict(
        max_abs_err=max(step_errs), ms=ct["ms"], call_ms=ct["call_ms"], plain_ms=cpt["ms"],
        plain_call_ms=cpt["call_ms"], bound_ms=cb_ms, bound_by=cb_by, library_ms=None,
        bytes=c_bytes, ops=c_ops, plain_ops=c_plain_ops,
        max_abs_err_vs_unfused=max(fused_errs),
        substep_max_abs_err=max(errs), substep_ms=kt["ms"], substep_call_ms=kt["call_ms"],
        substep_plain_ms=pt["ms"], substep_plain_call_ms=pt["call_ms"], substep_bound_ms=b_ms,
        substep_bound_by=b_by, substep_bytes=nbytes, substep_ops=ops,
        substep_plain_ops=plain_ops,
        c2t_max_abs_err=max(c2t_errs), c2t_ms=c2t["ms"], c2t_call_ms=c2t["call_ms"],
        c2t_pd_path_ms=pd_path["ms"], c2t_bound_ms=c2t_b_ms, c2t_bound_by=c2t_b_by,
        c2t_null_bitwise=True, c2t_impulse_scale=imp_mpc,
        time_source={"substep": kt["source"], "substep_plain": pt["source"],
                     "control_step": ct["source"], "control_step_plain": cpt["source"],
                     "control_step_c2t": c2t["source"]})
    log(f"[3] phys_substep B={FULL_B}: kernel {kt['ms']:.4f} ms on the device "
        f"({kt['source']}; {kt['call_ms']:.4f} ms a wrapper call; first design "
        f"{PREV_MS['phys_substep']:.4f} ms), plain {pt['ms']:.3f} ms device / "
        f"{pt['call_ms']:.3f} ms a call, bound {b_ms:.5f} ms ({b_by}: {nbytes} B, {ops} ops "
        f"needed; the plain version does {plain_ops})")
    log(f"[3] control_step B={FULL_B} x{n_sub}: kernel {ct['ms']:.4f} ms on the device "
        f"({ct['source']}; {ct['call_ms']:.4f} ms a wrapper call; {n_sub} launches of the first "
        f"design {PREV_CONTROL_STEP_MS:.4f} ms), plain loop {cpt['ms']:.2f} ms device / "
        f"{cpt['call_ms']:.2f} ms a call, bound {cb_ms:.5f} ms ({cb_by}: {c_bytes} B, "
        f"{c_ops} ops needed; the plain loop does {c_plain_ops})")
    log(f"[3] control_step B={FULL_B} x{n_sub} at impulse_scale {imp_mpc:g}: with tau_ff and "
        f"pd_scale {c2t['ms']:.4f} ms on the device ({c2t['source']}), without "
        f"{pd_path['ms']:.4f} ms; bound with them {c2t_b_ms:.5f} ms ({c2t_b_by}); max |err| vs "
        f"the plain loop over {len(c2t_errs)} cases {max(c2t_errs):.3g}")


class _GridCells:
    """Inside, the distinct heightmap samples that the plain terrain lookups
    read (the four corners of each lookup's cell), as flat indices."""

    def __enter__(self):
        self.saved, self.cells = terrain._bilinear, []

        def recorded(g, ox, oy, cell, z_scale, x, y):
            ny, nx = g.shape
            ix = torch.floor(torch.clamp((x + ox) / cell, 0.0, nx - 1.001)).long()
            iy = torch.floor(torch.clamp((y + oy) / cell, 0.0, ny - 1.001)).long()
            at = iy * nx + ix
            self.cells.append(torch.cat([at, at + 1, at + nx, at + nx + 1]).flatten())
            return self.saved(g, ox, oy, cell, z_scale, x, y)
        terrain._bilinear = recorded
        return self

    def __exit__(self, *exc):
        terrain._bilinear = self.saved

    def count(self) -> int:
        return int(torch.unique(torch.cat(self.cells)).numel())


def _terrain_inputs(B: int, seed: int, z_scale: float = 0.1):
    """Control-step inputs on terrain: offsets spread over the whole map (some
    past its edges, where the lookup clips), each base 0.30 m above the ground
    under it."""
    args = list(_control_inputs(B, seed, motor_dynamics=False))
    rng = np.random.default_rng(seed + 3)
    off = np.stack([rng.uniform(-5.0, 505.0, B), rng.uniform(-5.0, 55.0, B)], -1)
    tp = terrain.at_offsets(torch.tensor(off, dtype=torch.float32, device=DEVICE), z_scale)
    gc = args[2].clone()
    gc[2] += terrain.height(tp, gc[0], gc[1])
    args[2] = gc
    return args, terrain.rows(tp)


def _check_phys_terrain(rec: dict) -> None:
    """The control step on terrain: the heightmap the card got, the kernel
    against its plain loop, z_scale 0 against flat ground, times and bound."""
    cfg = config.test_default()
    g = terrain.grid(torch.device(DEVICE))
    gsum = float(g.double().sum())
    samples = [float(g[iy, ix]) for iy, ix in TERRAIN_GRID_AT]
    s_err = max(abs(a - b) for a, b in zip(samples, TERRAIN_GRID_SAMPLES))
    if not (abs(gsum - TERRAIN_GRID_SUM) <= 1e-6 * abs(TERRAIN_GRID_SUM) and s_err <= 1e-6):
        raise RuntimeError(f"the heightmap differs from the CPU's: sum {gsum} (CPU "
                           f"{TERRAIN_GRID_SUM}), samples off by {s_err}")
    log(f"[3] terrain heightmap {tuple(g.shape)}: sum {gsum:.9g} (CPU {TERRAIN_GRID_SUM:.9g}), "
        f"16 samples within {s_err:.2g} of the CPU's")
    tail = (cfg.substeps, cfg.contact_slip_vel, 0.0, cfg.simulation_dt)
    errs, cells = [], 0
    for B in (FULL_B, 37):
        args, terr = _terrain_inputs(B, seed=B + 21)
        got = phys_cuda.control_step(*args, *tail, terrain=terr)
        with _GridCells() as gcells:
            plain = phys_cuda.control_step_plain(*args, *tail, terrain=terr)
        flat = phys_cuda.control_step(*args, *tail)
        torch.cuda.synchronize()
        if torch.equal(got[5], flat[5]):
            raise RuntimeError("the terrain changed no contact force")
        errs.append(_assert_rows(got, plain, STEP_ATOL, 1e-3))
        if B == FULL_B:
            cells = gcells.count()
        by_row = ", ".join(f"{n} {float((a - b).abs().max()):.2g}" for n, a, b in zip(
            ("gc", "gv", "toe", "toe vel", "|f|", "fn", "torque"), got, plain))
        log(f"[3] control_step on terrain B={B} x{cfg.substeps}: vs plain loop max |err| "
            f"{errs[-1]:.3g} ({by_row})")
    args, terr0 = _terrain_inputs(FULL_B, seed=5, z_scale=0.0)
    zero = phys_cuda.control_step(*args, *tail, terrain=terr0)
    flat = phys_cuda.control_step(*args, *tail)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(zero, flat)):
        raise RuntimeError("control_step with the grid at z_scale 0 differs from flat ground")
    log(f"[3] control_step B={FULL_B}: grid at z_scale 0 == flat ground, bit for bit")

    args, terr = _terrain_inputs(FULL_B, seed=FULL_B + 21)
    # flat and terrain in turns (flat, terrain, terrain, flat, twice), each turn the
    # median of REPS launches; the record reads the median turn of each, with the
    # SM clock and power draw read after the last
    turns = {"flat": [], "terrain": []}
    for which in ("flat", "terrain", "terrain", "flat") * 2:
        t = terr if which == "terrain" else None
        turns[which].append(timings(lambda: phys_cuda.control_step(*args, *tail, terrain=t),
                                    kernel="phys_control_step_kernel"))
    on, off = (min(turns[k], key=lambda r, k=k: abs(r["ms"] - statistics.median(
        x["ms"] for x in turns[k]))) for k in ("terrain", "flat"))
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    plain = timings(lambda: phys_cuda.control_step_plain(*args, *tail, terrain=terr), reps=1)
    t_ops = FULL_B * phys_ops_per_env(cfg.substeps, pd_law=True, terrain=True)
    # the flat step's rows, each env's offset (2), cell and scale, and the distinct
    # samples the lookups of this input read
    t_bytes = 4 * (FULL_B * (phys_cuda.P_ROWS + 19 + 18 + 12 + 12 + 6 + phys_cuda.STEP_OUT_ROWS
                             + 4) + cells)
    t_b_ms, t_b_by = bound_ms(t_bytes, t_ops)
    rec["phys_substep"].update(
        terrain_max_abs_err=max(errs), terrain_ms=on["ms"], terrain_call_ms=on["call_ms"],
        terrain_flat_ms=off["ms"], terrain_plain_ms=plain["ms"],
        terrain_plain_call_ms=plain["call_ms"], terrain_bound_ms=t_b_ms,
        terrain_bound_by=t_b_by, terrain_bytes=t_bytes, terrain_ops=t_ops,
        terrain_grid_cells=cells, terrain_zero_bitwise=True, terrain_grid_sum=gsum,
        terrain_turns_ms={k: [r["ms"] for r in v] for k, v in turns.items()},
        terrain_clocks=clocks)
    rec["phys_substep"]["time_source"].update(control_step_terrain=on["source"])
    log(f"[3] control_step B={FULL_B} x{cfg.substeps} on terrain: {on['ms']:.4f} ms on the device "
        f"({on['source']}), flat {off['ms']:.4f} ms (median turns; terrain "
        + " ".join(f"{r['ms']:.4f}" for r in turns["terrain"]) + ", flat "
        + " ".join(f"{r['ms']:.4f}" for r in turns["flat"]) + f"; SM clock, power after: "
        f"{clocks}); plain loop {plain['ms']:.2f} ms device / {plain['call_ms']:.2f} ms a call; "
        f"bound {t_b_ms:.5f} ms ({t_b_by}: {t_bytes} B with {cells} distinct heightmap "
        f"samples, {t_ops} ops needed)")


def wb_problems(cfg, batch: int, horizon: int, device=DEVICE) -> trot.TrotProblem:
    """bench.py's whole-body problems: from the stand at rest, commands 1-4 m/s
    over 5 values."""
    i = np.arange(batch)
    cmds = torch.tensor(np.stack([1.0 + 3.0 * (i % 5) / 4.0, 0.0 * i, 0.0 * i], -1),
                        dtype=torch.float32, device=device)
    x0 = trot.standing_x0(cfg, device)
    return trot.make_problem(cfg, x0[:19].expand(batch, 19), torch.zeros(batch, 18, device=device),
                             cmds, torch.zeros(batch, device=device), horizon)


def wb_setup(linearizer: str, n_iter: int = WB_ITERS):
    """bench.py's whole-body problem set on the card: (cfg, MPCConfig, nominal
    params, TrotProblem of WB_BATCH problems)."""
    cfg = config.test_default().replace(obs_noise=0.0)
    mc = trot.MPCConfig(horizon=WB_HORIZON, n_iter=n_iter, model_substeps=2, linearize_chunk=1,
                        linearizer=linearizer)
    return cfg, mc, mdl.nominal_params(cfg, device=DEVICE), wb_problems(cfg, WB_BATCH, WB_HORIZON)


class _SubstepInputs:
    """Inside, the inputs of the last ``phys_cuda.substep`` call at each lane
    width (cloned), by width."""

    def __enter__(self):
        self.saved, self.last = phys_cuda.substep, {}

        def recorded(P, gcT, gvT, tauT, bwT, slip, imp, dt):
            self.last[gcT.shape[-1]] = (P, gcT.clone(), gvT.clone(), tauT.clone(), bwT.clone(),
                                        slip, imp, dt)
            return self.saved(P, gcT, gvT, tauT, bwT, slip, imp, dt)
        phys_cuda.substep = recorded
        return self

    def __exit__(self, *exc):
        phys_cuda.substep = self.saved


def _assert_rows_finite(got, want, atols, rtol: float) -> tuple[float, int]:
    """Kernel rows against plain rows over lanes (last axis): the lanes with a
    non-finite value must be the same on both sides; the finite ones within
    ``atols`` (velocity and force rows 1, 3, 4, 5 also within ``rtol``
    relative). Returns (max |err| over the finite lanes, non-finite lanes)."""
    def bad(rows):
        return ~torch.stack([torch.isfinite(r).reshape(-1, r.shape[-1]).all(0)
                             for r in rows]).all(0)
    bad_got, bad_want = bad(got), bad(want)
    if not torch.equal(bad_got, bad_want):
        raise RuntimeError(f"non-finite lanes differ: kernel {int(bad_got.sum())}, plain "
                           f"{int(bad_want.sum())}, in one only {int((bad_got ^ bad_want).sum())}")
    ok = ~bad_want
    err = 0.0
    for i, atol in enumerate(atols):
        g, w = got[i][..., ok], want[i][..., ok]
        torch.testing.assert_close(g, w, atol=atol, rtol=rtol if i in (1, 3, 4, 5) else 0)
        err = max(err, float((g - w).abs().max()))
    return err, int(bad_want.sum())


def _check_phys_mpc(rec: dict) -> None:
    """(e) The single substep at the whole-body MPC's operating point: dt =
    control_dt / 2 = 1 ms, on the inputs of the last launch at each lane width
    of a bench-shape lanes solve with FD Jacobians (1 iteration): the rollout
    (64), the line search (64 x 8 step sizes = 512) and the FD sweep (64 x 1
    knot x 2 (37 + 12) = 6272), kernel against plain; then both timed at 512
    and 6272 lanes."""
    cfg, mc, params, probs = wb_setup("fd", n_iter=1)
    with _SubstepInputs() as rec_in:
        trot.solve_batch_lanes(cfg, mc, params, probs)
    torch.cuda.synchronize()
    widths = sorted(rec_in.last)
    want_widths = [WB_BATCH, WB_BATCH * mc.n_alphas, WB_BATCH * 2 * (37 + 12)]
    if widths != want_widths:
        raise RuntimeError(f"whole-body lanes solve launched at widths {widths}, "
                           f"expected {want_widths}")
    out = {}
    for K in widths:
        args = rec_in.last[K]
        got = phys_cuda.substep(*args)
        want = lanes.substep(*args)
        torch.cuda.synchronize()
        err, n_bad = _assert_rows_finite(got, want, MPC_SUBSTEP_ATOL, MPC_SUBSTEP_RTOL)
        speed = float(args[2][6:].abs().max())
        log(f"[3] phys_substep at dt {args[7] * 1e3:g} ms, K={K} (whole-body solve's inputs, "
            f"joint speeds up to {speed:.3g} rad/s): matches plain, max |err| {err:.3g}, "
            f"{n_bad} non-finite lanes on both sides")
        entry = {"max_abs_err": err, "non_finite_lanes": n_bad}
        if K != WB_BATCH:
            kt = timings(lambda: phys_cuda.substep(*args), kernel="phys_substep_kernel")
            pt = timings(lambda: lanes.substep(*args), reps=3)
            ops = K * phys_ops_per_env(1, pd_law=False)
            # the MPC's lanes share one nominal robot: its parameters are read once
            # (make_dynamics_batch hands the kernel K copies; ROADMAP Queue 2)
            nbytes = 4 * (phys_cuda.P_ROWS + K * (19 + 18 + 12 + 6 + phys_cuda.OUT_ROWS))
            b_ms, b_by = bound_ms(nbytes, ops)
            entry.update(ms=kt["ms"], call_ms=kt["call_ms"], plain_ms=pt["ms"],
                         plain_call_ms=pt["call_ms"], bound_ms=b_ms, bound_by=b_by)
            log(f"[3] phys_substep K={K}: kernel {kt['ms']:.4f} ms on the device ({kt['source']}; "
                f"{kt['call_ms']:.4f} ms a wrapper call), plain {pt['ms']:.2f} ms device / "
                f"{pt['call_ms']:.2f} ms a call, bound {b_ms:.5f} ms ({b_by})")
        out[K] = entry
    rec["phys_substep"]["wb_max_abs_err"] = max(e["max_abs_err"] for e in out.values())
    rec["phys_substep"]["wb_widths"] = out


def _lstm_pair_inputs(B: int, d: int, n: int, seed: int, masked: bool):
    """Two weight sets and strided views of one packed state, as forward()
    hands them to the pair launch."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=DEVICE)  # noqa: E731
    mk = lambda: lstm.LSTMWeights(wx=r(d, 4 * n, scale=0.2), wh=r(n, 4 * n, scale=0.2),  # noqa: E731
                                  b=r(4 * n, scale=0.1))
    w0, w1, state, xs = mk(), mk(), r(B, 4 * n), r(B, 2 * d + 3)
    mask = (torch.rand(B, generator=g, device=DEVICE) < 0.4).float() if masked else None
    return (w0, w1, xs[:, :d], xs[:, d:2 * d], state[:, :n], state[:, n:2 * n],
            state[:, 2 * n:3 * n], state[:, 3 * n:], mask)


def _check_lstm(rec: dict) -> None:
    n = 48
    errs, pair_errs, per_d = [], [], {}
    for d in (35, 48):
        for B in (FULL_B, 37, 5):
            w, x, c, h = _lstm_inputs(B, d, n, seed=B + d)
            want = lstm.lstm_cell(w, x, c, h)
            got = lstm_cuda.lstm_cell(w, x, c, h)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
            errs.append(max_err(got, want))
            for masked in (False, True):
                pargs = _lstm_pair_inputs(B, d, n, seed=B + d + masked, masked=masked)
                want = lstm.lstm_cell_pair(*pargs)
                got = lstm_cuda.lstm_cell_pair(*pargs)
                torch.cuda.synchronize()
                for g_, w_ in zip(got, want):
                    torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
                pair_errs.append(max_err(got, want))
        w, x, c, h = _lstm_inputs(FULL_B, d, n, seed=d)
        lib = _torch_lstm_cell(w, x, c, h)
        hy, cy = lib()
        torch.testing.assert_close((cy, hy), lstm.lstm_cell(w, x, c, h), atol=1e-5, rtol=0)
        nbytes = 4 * (FULL_B * d + 2 * FULL_B * n + (d + n) * 4 * n + 4 * n + 2 * FULL_B * n)
        ops = count_ops(lambda: lstm.lstm_cell(w, x, c, h))
        pargs = _lstm_pair_inputs(FULL_B, d, n, seed=d, masked=True)
        # the pair's yardstick: torch.lstm_cell once a tower, on states reset beforehand
        w0, w1, x0, x1, c0, h0, c1, h1, mask = pargs
        keep = (1.0 - mask)[:, None]
        lib0 = _torch_lstm_cell(w0, x0.contiguous(), c0 * keep, h0 * keep)
        lib1 = _torch_lstm_cell(w1, x1.contiguous(), c1 * keep, h1 * keep)
        (hy0, cy0), (hy1, cy1) = lib0(), lib1()
        torch.testing.assert_close((cy0, hy0, cy1, hy1), lstm.lstm_cell_pair(*pargs),
                                   atol=1e-5, rtol=0)
        pair_bytes = 2 * nbytes + 4 * FULL_B
        pair_ops = count_ops(lambda: lstm.lstm_cell_pair(*pargs))
        kt = timings(lambda: lstm_cuda.lstm_cell(w, x, c, h), kernel="lstm_cell_kernel")
        pk = timings(lambda: lstm_cuda.lstm_cell_pair(*pargs), kernel="lstm_cell_pair_kernel")
        pt = timings(lambda: lstm.lstm_cell(w, x, c, h))
        ppt = timings(lambda: lstm.lstm_cell_pair(*pargs))
        lt = timings(lib)
        plt = timings(lambda: (lib0(), lib1()))
        per_d[d] = dict(ms=pk["ms"], call_ms=pk["call_ms"], plain_ms=ppt["ms"],
                        plain_call_ms=ppt["call_ms"], library_ms=plt["ms"],
                        library_call_ms=plt["call_ms"], bound=bound_ms(pair_bytes, pair_ops),
                        bytes=pair_bytes, ops=pair_ops,
                        cell_ms=kt["ms"], cell_call_ms=kt["call_ms"], cell_plain_ms=pt["ms"],
                        cell_plain_call_ms=pt["call_ms"], cell_library_ms=lt["ms"],
                        cell_library_call_ms=lt["call_ms"], cell_bound=bound_ms(nbytes, ops),
                        cell_bytes=nbytes, cell_ops=ops,
                        time_source={"pair": pk["source"], "pair_plain": ppt["source"],
                                     "pair_library": plt["source"], "cell": kt["source"],
                                     "cell_plain": pt["source"], "cell_library": lt["source"]})
        p = per_d[d]
        log(f"[3] lstm_cell B={FULL_B} d={d}: kernel {p['cell_ms']:.4f} ms on the device "
            f"({kt['source']}; {p['cell_call_ms']:.4f} ms a wrapper call; first design "
            f"{PREV_MS['lstm_cell']:.4f} ms, mean of both widths), plain "
            f"{p['cell_plain_ms']:.4f} ms, torch.lstm_cell {p['cell_library_ms']:.4f} ms "
            f"({p['cell_library_call_ms']:.4f} ms a call), bound {p['cell_bound'][0]:.5f} ms "
            f"({p['cell_bound'][1]}: {nbytes} B, {ops} ops); max |err| {max(errs):.3g}")
        log(f"[3] lstm_cell_pair B={FULL_B} d={d} (two cells, masked, strided state): kernel "
            f"{p['ms']:.4f} ms on the device ({pk['source']}; {p['call_ms']:.4f} ms a wrapper "
            f"call), plain {p['plain_ms']:.4f} ms, torch.lstm_cell twice {p['library_ms']:.4f} "
            f"ms, bound {p['bound'][0]:.5f} ms ({p['bound'][1]}: {pair_bytes} B, {pair_ops} "
            f"ops); max |err| {max(pair_errs):.3g}")
    # the record reads the two-tower launch, the entry point the main path launches once at
    # each width; the single cell stands beside it under cell_*
    pair = entry_record({f"d={d}": dict(
        ms=p["ms"], call_ms=p["call_ms"], plain_ms=p["plain_ms"], plain_call_ms=p["plain_call_ms"],
        bound_ms=p["bound"][0], bound_by=p["bound"][1], library_ms=p["library_ms"],
        library_call_ms=p["library_call_ms"]) for d, p in per_d.items()})
    cell = entry_record({f"d={d}": dict(
        ms=p["cell_ms"], call_ms=p["cell_call_ms"], plain_ms=p["cell_plain_ms"],
        bound_ms=p["cell_bound"][0], bound_by=p["cell_bound"][1],
        library_ms=p["cell_library_ms"]) for d, p in per_d.items()})
    rec["lstm_cell"] = dict(pair, max_abs_err=max(pair_errs), cell_max_abs_err=max(errs),
                            **{f"cell_{k}": v for k, v in cell.items()}, per_width=per_d)


def _lstm_rows_inputs(B: int, d: int, n: int, seed: int, masked: bool):
    """Two towers' weight sets with one set a row, and strided views of one
    packed state, as forward() hands them to the per-row launch; the mask is
    the landscape's all-zero no-reset mask unless ``masked``."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=DEVICE)  # noqa: E731
    mk = lambda: lstm.LSTMWeights(wx=r(B, d, 4 * n, scale=0.2),  # noqa: E731
                                  wh=r(B, n, 4 * n, scale=0.2), b=r(B, 4 * n, scale=0.1))
    w0, w1, state, xs = mk(), mk(), r(B, 4 * n), r(B, 2 * d + 3)
    mask = ((torch.rand(B, generator=g, device=DEVICE) < 0.4).float() if masked
            else torch.zeros(B, device=DEVICE))
    return (w0, w1, xs[:, :d], xs[:, d:2 * d], state[:, :n], state[:, n:2 * n],
            state[:, 2 * n:3 * n], state[:, 3 * n:], mask)


def _check_lstm_rows(rec: dict) -> None:
    """lstm_cell_pair_rows_kernel (both towers, one weight set a row) against
    its plain version, at the landscape's batches and two ragged ones, with
    and without resets; timed at the
    landscape's batches. No single PyTorch call computes an LSTM cell with
    per-row weights: no library yardstick."""
    n, errs, per = 48, [], {}
    for d in (35, 48):
        for B in ROWS_B + (37, 5):
            for masked in (False, True):
                args = _lstm_rows_inputs(B, d, n, seed=B + d + masked, masked=masked)
                want = lstm.lstm_cell_pair_rows(*args)
                got = lstm_cuda.lstm_cell_pair_rows(*args)
                torch.cuda.synchronize()
                for g_, w_ in zip(got, want):
                    torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
                errs.append(max_err(got, want))
        for B in ROWS_B:
            args = _lstm_rows_inputs(B, d, n, seed=d, masked=False)
            # every weight read once (both towers), x, h and c of each tower, the mask, c' and h'
            nbytes = 4 * (2 * B * (d + n + 1) * 4 * n + 2 * B * (d + 2 * n) + B + 4 * B * n)
            # the gate products' FMAs (torch.bmm, which OpCounter does not count) + the rest
            ops = 2 * 2 * B * (d + n) * 4 * n + count_ops(lambda: lstm.lstm_cell_pair_rows(*args))
            kt = timings(lambda: lstm_cuda.lstm_cell_pair_rows(*args),
                         kernel="lstm_cell_pair_rows_kernel")
            pt = timings(lambda: lstm.lstm_cell_pair_rows(*args))
            bound = bound_ms(nbytes, ops)
            per[f"B={B} d={d}"] = dict(ms=kt["ms"], call_ms=kt["call_ms"], plain_ms=pt["ms"],
                                       plain_call_ms=pt["call_ms"], bound_ms=bound[0],
                                       bound_by=bound[1], library_ms=None, bytes=nbytes, ops=ops,
                                       time_source={"kernel": kt["source"],
                                                    "plain": pt["source"]})
            p = per[f"B={B} d={d}"]
            log(f"[3] lstm_cell_pair_rows B={B} d={d} (two towers, a weight set a row): kernel "
                f"{p['ms']:.4f} ms on the device ({kt['source']}; {p['call_ms']:.4f} ms a wrapper "
                f"call), plain {p['plain_ms']:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}: "
                f"{nbytes} B, {ops} ops), {bound[0] / p['ms']:.1%} of it; max |err| "
                f"{max(errs):.3g}")
    rec["lstm_cell_rows"] = dict(entry_record(per), max_abs_err=max(errs))


def entry_record(per_launch: dict) -> dict:
    """The times of an entry point that the main path launches at more than
    one shape: ms, plain_ms, bound_ms, bound_by and library_ms are those of
    the one launch shape farthest from its own bound, named under ``shape``;
    ``per_launch`` holds every shape with its own."""
    worst = max(per_launch, key=lambda k: per_launch[k]["ms"] / per_launch[k]["bound_ms"])
    return {**per_launch[worst], "shape": worst, "per_launch": per_launch}


def kernel_medians(fn, reps: int, names, tries: int = 3) -> dict:
    """Median device time (ms) of the launches of each named kernel inside
    ``reps`` calls of ``fn``, from torch.profiler's CUDA events; None for a
    kernel no window of ``tries`` held (the profiler can lose events: §7 of
    PERF.md), which the caller then times by CUDA events."""
    fn()
    torch.cuda.synchronize()
    seen = {n: None for n in names}
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        for n in names:
            durs = [ms for name, ms in events if n in name]
            if durs and seen[n] is None:
                seen[n] = statistics.median(durs)
        if all(v is not None for v in seen.values()):
            break
    return seen


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_()


def _layer_problem(B: int, d: int, towers: int, masked: bool, T: int, seed: int,
                   need_dx: bool = True, loss_on_c: bool = True):
    """One LSTM layer of ``towers`` towers over T steps as models.lstm.sequence
    hands it to ops.lstm_cuda.lstm_layer_sequence: leaf tensors for the
    weights, the inputs (views of one wider buffer; leaves only if
    ``need_dx``) and one packed initial state read through strided views, a
    (T, B) mask, and a scalar loss that sends a gradient to every step's h'
    (and c' if ``loss_on_c``). -> (leaves, run, data); run(layer_fn, leaves[,
    probes]) -> (outputs, loss). probes: a (B, 4n) zero leaf a tower added to
    the plain cells' bias, whose gradient is that of the pre-activation gates
    row by row, summed over the steps. data: the inputs that are no leaves."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=DEVICE)  # noqa: E731
    n = 48
    xs_all = r(T, B, towers * d)
    leaves = {"state": _leaf(r(B, 2 * n * towers + 5))}
    if need_dx:
        leaves["xs"] = _leaf(xs_all)
    for i in range(towers):
        leaves.update({f"wx{i}": _leaf(r(d, 4 * n, scale=0.2)),
                       f"wh{i}": _leaf(r(n, 4 * n, scale=0.2)), f"b{i}": _leaf(r(4 * n, scale=0.1))})
    mask = (torch.rand(T, B, generator=g, device=DEVICE) < 0.3).float() if masked else None
    weights = [(r(T, B, n), r(T, B, n)) for _ in range(towers)]

    def run(layer_fn, lv, probes=None):
        bias = lambda i: lv[f"b{i}"] if probes is None else lv[f"b{i}"] + probes[i]  # noqa: E731
        ws = [lstm.LSTMWeights(lv[f"wx{i}"], lv[f"wh{i}"], bias(i)) for i in range(towers)]
        x_all = lv["xs"] if need_dx else xs_all
        xs = [x_all[:, :, i * d:(i + 1) * d] for i in range(towers)]
        states = [(lv["state"][:, 2 * n * i:2 * n * i + n],
                   lv["state"][:, 2 * n * i + n:2 * n * (i + 1)]) for i in range(towers)]
        out = layer_fn(ws, xs, mask, states)
        loss = sum((h * wh).sum() + ((c * wc).sum() if loss_on_c else 0.0)
                   for (c, h), (wc, wh) in zip(out, weights))
        return out, loss
    return leaves, run, {"xs_all": xs_all, "mask": mask, "weights": weights}


def _torch_lstm_layer_loss(leaves, data, d: int, towers: int):
    """The loss of _layer_problem's layer (masked, on h' only) through
    torch.lstm_cell, once a tower and step, on states reset beforehand; a
    yardstick only, the port never calls it."""
    mask, weights = data["mask"], data["weights"]
    xs_all = leaves.get("xs", data["xs_all"])
    n, T = 48, xs_all.shape[0]
    perm = torch.cat([torch.arange(0, 2 * n), torch.arange(3 * n, 4 * n),
                      torch.arange(2 * n, 3 * n)]).to(DEVICE)
    loss = 0.0
    for i in range(towers):
        w_ih, w_hh = leaves[f"wx{i}"][:, perm].T, leaves[f"wh{i}"][:, perm].T
        b, zero = leaves[f"b{i}"][perm], torch.zeros(4 * n, device=DEVICE)
        c = leaves["state"][:, 2 * n * i:2 * n * i + n]
        h = leaves["state"][:, 2 * n * i + n:2 * n * (i + 1)]
        for t in range(T):
            keep = (1.0 - mask[t])[:, None]
            h, c = torch.lstm_cell(xs_all[t, :, i * d:(i + 1) * d], [h * keep, c * keep],
                                   w_ih, w_hh, b, zero)
            loss = loss + (h * weights[i][1][t]).sum()
    return loss


def _lstm_library_ms(leaves, data, d: int, need_dx: bool) -> dict:
    """The yardstick of the sequence kernels: torch.nn.LSTM (cuDNN, one layer,
    hidden 48, the gate columns permuted to PyTorch's [i, f, g, o], TF32 off)
    once a tower over _layer_problem's unmasked sequence, forward and autograd's
    backward (which also computes the weight gradients). It has no reset
    within a sequence, so it runs the unmasked case; a yardstick only, the
    port never calls it."""
    n, xs_all, weights = 48, leaves.get("xs", data["xs_all"]), data["weights"]
    perm = torch.cat([torch.arange(0, 2 * n), torch.arange(3 * n, 4 * n),
                      torch.arange(2 * n, 3 * n)]).to(DEVICE)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        nets, inputs = [], []
        for i in range(2):
            net = torch.nn.LSTM(d, n).to(DEVICE)
            with torch.no_grad():
                net.weight_ih_l0.copy_(leaves[f"wx{i}"][:, perm].T)
                net.weight_hh_l0.copy_(leaves[f"wh{i}"][:, perm].T)
                net.bias_ih_l0.copy_(leaves[f"b{i}"][perm])
                net.bias_hh_l0.zero_()
            h0 = leaves["state"][:, 2 * n * i + n:2 * n * (i + 1)].detach()[None].contiguous()
            c0 = leaves["state"][:, 2 * n * i:2 * n * i + n].detach()[None].contiguous()
            nets.append(net)
            inputs.append((_leaf(xs_all[:, :, i * d:(i + 1) * d].detach().contiguous()), (h0, c0)))

        def forward():
            return [net(x, hc)[0] for net, (x, hc) in zip(nets, inputs)]
        hs = forward()
        loss = sum((h * w[1]).sum() for h, w in zip(hs, weights))
        params = [t for net, (x, _) in zip(nets, inputs)
                  for t in ((x,) if need_dx else ()) + tuple(net.parameters())]
        # device time by the profiler, or CUDA events around a call where no window of the
        # profiler's held every event of its calls
        fwd = timings(forward, reps=3)
        bwd = timings(lambda: torch.autograd.grad(loss, params, retain_graph=True), reps=3)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    return {"fwd_ms": fwd["ms"], "bwd_ms": bwd["ms"], "fwd_source": fwd["source"],
            "bwd_source": bwd["source"], "h_seq": [h.detach() for h in hs]}


def _check_lstm_training(rec: dict) -> None:
    """The two sequence kernels (the forward that keeps the gates, and the
    backward), one launch a layer each way, through the autograd Function of
    ops.lstm_cuda.lstm_layer_sequence: against autograd of the plain cells at
    T = 1 over _check_lstm's batches and one and two towers, and at T = 4;
    then at the epochs' T = 750, B = 1024 for the main path's two layers (d =
    35 without dx, d = 48 with it) against the kernels' plain versions
    (ops.lstm_cuda.lstm_layer_forward_plain, lstm_layer_backward_plain,
    layer_weight_grads: every step's gates and gate gradients), and timed
    there beside them, torch.nn.LSTM and the bound counted once a sequence."""
    n, t0 = 48, time.perf_counter()
    fwd_errs, same_as_inference, grad_errs, grad_rel = [], [], [], []
    flat = lambda out: [t for pair in out for t in pair]  # noqa: E731

    def held(k, a, b):   # a gradient against the plain one, within GRAD_RTOL of its scale
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-5 + GRAD_RTOL * scale, rtol=0,
                                   msg=lambda m: f"{k}: {m}")
        err = float((a - b).abs().max())
        grad_rel.append(err / max(scale, 1e-30))
        return err

    def launched_once(before, what):
        torch.cuda.synchronize()
        if (lstm_cuda.train_launches, lstm_cuda.bwd_launches) != (before[0] + 1, before[1] + 1):
            raise RuntimeError(f"{what}: expected one sequence-forward and one sequence-backward "
                               f"launch")

    configs = ((2, True, True), (2, False, True), (2, True, False), (1, True, True),
               (1, False, False))
    cases = [(B, d, 1, *c) for d in (35, 48) for B in (FULL_B, 37, 5) for c in configs]
    cases += [(B, d, 4, *c) for d in (35, 48) for B in (FULL_B, 37, 5) for c in configs[::4]]
    for B, d, T, towers, masked, need_dx in cases:
        leaves, run, _ = _layer_problem(B, d, towers, masked, T, seed=B + d + towers + T,
                                        need_dx=need_dx)
        plain = {k: _leaf(v) for k, v in leaves.items()}
        before = (lstm_cuda.train_launches, lstm_cuda.bwd_launches)
        got, loss = run(lstm_cuda.lstm_layer_sequence, leaves)
        kept = got[0][0].grad_fn.gates   # activated gates; the backward leaves dgates here
        loss.backward()
        launched_once(before, f"lstm layer T={T}")
        with torch.no_grad():   # the inference kernels on the same inputs, step by step
            inference, _ = run(lstm_cuda.lstm_layer_sequence, leaves)
        probes = [torch.zeros(B, 4 * n, device=DEVICE, requires_grad=True)
                  for _ in range(towers)]
        want, loss_plain = run(lstm_cuda.lstm_layer_sequence_plain, plain, probes)
        loss_plain.backward()
        for g_, i_, w_ in zip(flat(got), flat(inference), flat(want)):
            torch.testing.assert_close(g_, i_, atol=1e-6, rtol=0)
            torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
        same_as_inference.append(all(torch.equal(a, b)
                                     for a, b in zip(flat(got), flat(inference))))
        fwd_errs.append(max_err(flat(got), flat(want)))
        # dx, dc and dh (through the strided state), dWx, dWh, db, and dgates row by row
        errs = {k: held(k, leaves[k].grad, plain[k].grad) for k in leaves}
        errs.update({f"dgates{i}": held(f"dgates{i}", kept[i].sum(0), probes[i].grad)
                     for i in range(towers)})
        case_errs = [e for k, e in errs.items() if k in ("xs", "state") or k.startswith("dgates")]
        grad_errs += case_errs
        if B == FULL_B:
            log(f"[3] lstm layer T={T} B={B} d={d} towers={towers} masked={masked} dx={need_dx}: "
                f"sequence forward max |err| {fwd_errs[-1]:.3g} vs plain (bitwise equal to the "
                f"inference kernel: {same_as_inference[-1]}); backward dx/dc/dh/dgates max "
                f"|err| {max(case_errs):.3g}")
    log(f"[3] lstm layer: {len(cases)} cases at T = 1 and 4 in {time.perf_counter() - t0:.1f} s")

    # the epochs' shape, both layers: held to the plain versions, then timed
    T, B = TRAIN_STEPS, FULL_B
    per_d = {}
    for d, need_dx in ((35, False), (48, True)):
        t1 = time.perf_counter()
        leaves, run, data = _layer_problem(B, d, 2, True, T, seed=d, need_dx=need_dx,
                                           loss_on_c=False)
        before = (lstm_cuda.train_launches, lstm_cuda.bwd_launches)
        got, loss = run(lstm_cuda.lstm_layer_sequence, leaves)
        kept = got[0][0].grad_fn.gates
        loss.backward()
        launched_once(before, f"lstm layer T={T}")
        args = {}

        def grab(ws, xs, mask, states):
            args.update(ws=ws, xs=xs, mask=mask, states=states,
                        fwd=lstm_cuda.lstm_layer_forward_plain(ws, xs, mask, states))
            return [(c, h) for c, h, _ in args["fwd"]]
        ups = [(None, wl) for _, wl in data["weights"]]   # the loss reaches h' alone
        plain_bwd = lambda: lstm_cuda.lstm_layer_backward_plain(  # noqa: E731
            args["ws"], args["xs"], args["mask"], args["states"], args["fwd"], ups, need_dx)
        with torch.no_grad():   # the plain loops are host-bound: CUDA events around each call
            inference, _ = run(lstm_cuda.lstm_layer_sequence, leaves)
            plain_fwd_ms = _events_ms(lambda: run(grab, {k: v.detach() for k, v in leaves.items()}))
            plain_bwd_ms, bwd = _events_ms(plain_bwd, keep=True)
            for g_, i_, (c, h, _) in zip(got, inference, args["fwd"]):
                for a_, b_, w_ in zip(g_, i_, (c, h)):
                    torch.testing.assert_close(a_, w_, atol=1e-5, rtol=0)
                same_as_inference.append(all(torch.equal(a_, b_) for a_, b_ in zip(g_, i_)))
                fwd_errs.append(max_err(g_, (c, h)))
            case_errs = []
            for i, ((dg, dx, dc0, dh0), x, (_, h0), (_, h_seq, _)) in enumerate(zip(
                    bwd, args["xs"], args["states"], args["fwd"])):
                case_errs.append(held(f"dgates{i}", kept[i], dg))
                case_errs.append(held(f"dc{i}", leaves["state"].grad[:, 2 * n * i:2 * n * i + n],
                                      dc0))
                case_errs.append(held(f"dh{i}", leaves["state"].grad[:, 2 * n * i + n:
                                                                       2 * n * (i + 1)], dh0))
                if need_dx:
                    case_errs.append(held(f"dx{i}", leaves["xs"].grad[:, :, i * d:(i + 1) * d],
                                          dx))
                for k, w_ in zip(("wx", "wh", "b"), lstm_cuda.layer_weight_grads(
                        x, args["mask"], h0, h_seq, dg)):
                    held(f"d{k}{i}", leaves[f"{k}{i}"].grad, w_)
            grad_errs += case_errs
        log(f"[3] lstm layer T={T} B={B} d={d} towers=2 masked=True dx={need_dx}: sequence forward "
            f"max |err| {fwd_errs[-1]:.3g} vs its plain version (bitwise equal to the inference "
            f"kernel: {same_as_inference[-1]}); backward: every step's dgates, dx, dc, dh max "
            f"|err| {max(case_errs):.3g}, dWx, dWh, db within {GRAD_RTOL:g} of their scale")
        del got, loss, kept, inference, bwd
        for v in leaves.values():
            v.grad = None
        med = kernel_medians(lambda: run(lstm_cuda.lstm_layer_sequence, leaves)[1].backward(),
                             SEQ_REPS, ("lstm_seq_train_kernel", "lstm_seq_bwd_kernel"))
        source = {k: "profiler" for k in ("train", "bwd")}
        if med["lstm_seq_train_kernel"] is None:   # CUDA events around the forward call
            med["lstm_seq_train_kernel"] = statistics.median(
                _events_ms(lambda: run(lstm_cuda.lstm_layer_sequence, leaves))
                for _ in range(SEQ_REPS))
            source["train"] = "events around the wrapper's forward call"

        def backward_ms():
            loss = run(lstm_cuda.lstm_layer_sequence, leaves)[1]
            torch.cuda.synchronize()
            return _events_ms(loss.backward)
        if med["lstm_seq_bwd_kernel"] is None:   # CUDA events around autograd's backward call
            med["lstm_seq_bwd_kernel"] = statistics.median(backward_ms() for _ in range(SEQ_REPS))
            source["bwd"] = "events around autograd's backward call, weight gradients included"
        # the yardstick on the same layer without resets, held to the plain cells first
        lib_leaves, lib_run, lib_data = _layer_problem(B, d, 2, False, T, seed=d + 1,
                                                       need_dx=need_dx, loss_on_c=False)
        lib = _lstm_library_ms(lib_leaves, lib_data, d, need_dx)
        with torch.no_grad():
            lib_want, _ = lib_run(lstm_cuda.lstm_layer_sequence_plain, lib_leaves)
        # cuDNN sums in its own order, and 750 steps of the recurrence carry it
        torch.testing.assert_close(lib["h_seq"], [h for _, h in lib_want], atol=1e-4, rtol=0)
        del lib_leaves, lib_want
        dx_cols = d if need_dx else 0
        cols = 2 if need_dx else 1
        # once a sequence, both towers: x, the initial state, [Wx; Wh] and b and the mask read,
        # c_seq, h_seq and the gates written; the operations: the pair's a step, T times
        train_bytes = 4 * (2 * (T * B * d + 2 * B * n + (d + n + 1) * 4 * n + T * B * 6 * n) + T * B)
        train_ops = T * rec["lstm_cell"]["per_width"][d]["ops"]
        # the gates read and dgates written, c_seq, the initial c, the gradient from above
        # (h' only) and the mask read, [Wh^T, Wx^T] read once, dx and the initial state's
        # gradients written; the products and 29 operations a gate tail, T times
        bwd_bytes = 4 * (2 * (T * B * (8 * n + n + n + dx_cols) + B * n + 4 * n * n * cols
                              + 2 * B * n) + T * B)
        bwd_ops = 2 * T * (2 * B * 4 * n * (n + dx_cols) + 29 * B * n)
        per_d[d] = dict(
            train_ms=med["lstm_seq_train_kernel"], bwd_ms=med["lstm_seq_bwd_kernel"],
            train_plain_ms=plain_fwd_ms, bwd_plain_ms=plain_bwd_ms,
            train_library_ms=lib["fwd_ms"], bwd_library_ms=lib["bwd_ms"],
            train_bound=bound_ms(train_bytes, train_ops), train_bytes=train_bytes,
            train_ops=train_ops, bwd_bound=bound_ms(bwd_bytes, bwd_ops), bwd_bytes=bwd_bytes,
            bwd_ops=bwd_ops, dx=need_dx, T=T,
            train_ptxas=ptxas_of("lstm_cell", "lstm_seq_train_kernel"),
            bwd_ptxas=ptxas_of("lstm_cell", f"ELi{cols}EEEvNS_10SeqBwdArgs"),   # <kR, kG, cols>
            train_smem_bytes=lstm_cuda.seq_smem_bytes(False, d, n),
            bwd_smem_bytes=lstm_cuda.seq_smem_bytes(True, dx_cols, n),
            train_prev_ms=T * PREV_SEQ_STEP_MS["train"][d],
            bwd_prev_ms=T * PREV_SEQ_STEP_MS["bwd"][d],
            train_time_source={"kernel": source["train"], "plain": "events",
                               "library": lib["fwd_source"]},
            bwd_time_source={"kernel": source["bwd"], "plain": "events",
                             "library": lib["bwd_source"]})
        p = per_d[d]
        for k, what in (("train", "forward"), ("bwd", "backward")):
            log(f"[3] lstm_seq_{k} T={T} B={B} d={d} dx={need_dx}: kernel {p[f'{k}_ms']:.4f} ms a "
                f"sequence on the device ({p[f'{k}_time_source']['kernel']}, median of "
                f"{SEQ_REPS}), "
                f"{p[f'{k}_ms'] / T * 1e3:.3f} us a step; the per-step kernel it replaces x{T} "
                f"{p[f'{k}_prev_ms']:.3f} ms; plain {what} {p[f'{k}_plain_ms']:.2f} ms a call "
                f"(events); torch.nn.LSTM {what} (cuDNN, no reset, twice) "
                f"{p[f'{k}_library_ms']:.4f} ms ({p[f'{k}_time_source']['library']}); "
                f"bound {p[f'{k}_bound'][0]:.4f} ms "
                f"({p[f'{k}_bound'][1]}: {p[f'{k}_bytes']} B, {p[f'{k}_ops']} ops), "
                f"{p[f'{k}_bound'][0] / p[f'{k}_ms']:.1%} of it; ptxas {p[f'{k}_ptxas']}, "
                f"{p[f'{k}_smem_bytes']} B dynamic shared memory")
        log(f"[3] lstm layer T={T} d={d}: {time.perf_counter() - t1:.1f} s")
        del leaves, run, data, args
    # one record an entry the training path launches, over the two layers' launch shapes
    def shape(d):
        return f"layer {1 if d == 35 else 2}: d={d}, {'dx' if per_d[d]['dx'] else 'no dx'}"
    for k in ("train", "bwd"):
        rec[f"lstm_seq_{k}"] = dict(entry_record({shape(d): dict(
            ms=p[f"{k}_ms"], ms_a_step=p[f"{k}_ms"] / T, plain_ms=p[f"{k}_plain_ms"],
            bound_ms=p[f"{k}_bound"][0], bound_by=p[f"{k}_bound"][1],
            library_ms=p[f"{k}_library_ms"], time_source=p[f"{k}_time_source"],
            ptxas=p[f"{k}_ptxas"], smem_bytes=p[f"{k}_smem_bytes"])
            for d, p in per_d.items()}), per_width=per_d)
    rec["lstm_seq_train"].update(max_abs_err=max(fwd_errs),
                                 bitwise_equal_to_inference=all(same_as_inference))
    rec["lstm_seq_bwd"].update(max_abs_err=max(grad_errs), max_rel_err=max(grad_rel))


def _analytic_inputs(B: int, seed: int):
    """Control-step inputs on the analytic fractal: seeds over [0, 1000), each
    base 0.30 m above the ground under it."""
    args = list(_control_inputs(B, seed, motor_dynamics=False))
    rng = np.random.default_rng(seed + 5)
    tp = terrain.with_seeds(torch.tensor(rng.uniform(0.0, 1000.0, B), device=DEVICE), 0.1)
    gc = args[2].clone()
    gc[2] += terrain.height(tp, gc[0], gc[1])
    args[2] = gc
    return args, terrain.rows(tp)


def ptxas_of(source: str, entry: str) -> dict | None:
    """Registers, spill bytes and stack frame of the kernel whose mangled name
    holds ``entry``, from this process's nvcc -Xptxas -v output (None if the
    library was built by another process)."""
    lines = _build.build_logs.get(source, "").splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and entry in ln:
            rec = {}
            for follow in lines[i + 1:i + 5]:
                if "Compiling entry" in follow:
                    break
                words = follow.replace(",", "").split()
                if "stack" in follow and "spill" in follow:
                    rec.update(stack_bytes=int(words[0]), spill_store_bytes=int(words[4]),
                               spill_load_bytes=int(words[8]))
                if "registers" in follow:
                    rec["registers"] = int(words[words.index("registers") - 1])
            return rec
    return None


def _check_phys_analytic(rec: dict) -> None:
    """The control step on the analytic fractal (its own instantiation of the
    kernel): against its plain loop at chain (c)'s tolerances, then its time
    beside the flat step's, in turns, the plain loop's, and the bound."""
    cfg = config.test_default()
    tail = (cfg.substeps, cfg.contact_slip_vel, 0.0, cfg.simulation_dt)
    errs = []
    for B in (FULL_B, 37):
        args, terr = _analytic_inputs(B, seed=B + 31)
        got = phys_cuda.control_step(*args, *tail, terrain=terr)
        plain = phys_cuda.control_step_plain(*args, *tail, terrain=terr)
        flat = phys_cuda.control_step(*args, *tail)
        torch.cuda.synchronize()
        if torch.equal(got[5], flat[5]):
            raise RuntimeError("the analytic terrain changed no contact force")
        errs.append(_assert_rows(got, plain, STEP_ATOL, 1e-3))
        by_row = ", ".join(f"{n} {float((a - b).abs().max()):.2g}" for n, a, b in zip(
            ("gc", "gv", "toe", "toe vel", "|f|", "fn", "torque"), got, plain))
        log(f"[3] control_step on the analytic terrain B={B} x{cfg.substeps}: vs plain loop max "
            f"|err| {errs[-1]:.3g} ({by_row})")
    args, terr = _analytic_inputs(FULL_B, seed=FULL_B + 31)
    turns = {"flat": [], "analytic": []}
    for which in ("flat", "analytic", "analytic", "flat") * 2:
        t = terr if which == "analytic" else None
        turns[which].append(timings(lambda: phys_cuda.control_step(*args, *tail, terrain=t),
                                    kernel="phys_control_step_kernel"))
    on, off = (min(turns[k], key=lambda r, k=k: abs(r["ms"] - statistics.median(
        x["ms"] for x in turns[k]))) for k in ("analytic", "flat"))
    plain = timings(lambda: phys_cuda.control_step_plain(*args, *tail, terrain=terr), reps=1)
    a_ops = FULL_B * phys_ops_per_env(cfg.substeps, pd_law=True, terrain=True, analytic=True)
    # the flat step's rows and each env's seed and height scale
    a_bytes = 4 * FULL_B * (phys_cuda.P_ROWS + 19 + 18 + 12 + 12 + 6 + phys_cuda.STEP_OUT_ROWS + 2)
    a_b_ms, a_b_by = bound_ms(a_bytes, a_ops)
    ptx = ptxas_of("phys_substep", "AnalyticTerrain")
    rec["phys_substep"].update(
        analytic_max_abs_err=max(errs), analytic_ms=on["ms"], analytic_call_ms=on["call_ms"],
        analytic_flat_ms=off["ms"], analytic_plain_ms=plain["ms"],
        analytic_plain_call_ms=plain["call_ms"], analytic_bound_ms=a_b_ms,
        analytic_bound_by=a_b_by, analytic_bytes=a_bytes, analytic_ops=a_ops,
        analytic_turns_ms={k: [r["ms"] for r in v] for k, v in turns.items()},
        analytic_ptxas=ptx, ptxas_map=ptxas_of("phys_substep", "INS_7TerrainE"),
        ptxas_substep=ptxas_of("phys_substep", "phys_substep_kernel"))
    rec["phys_substep"]["time_source"].update(control_step_analytic=on["source"])
    log(f"[3] control_step B={FULL_B} x{cfg.substeps} on the analytic terrain: {on['ms']:.4f} ms "
        f"on the device ({on['source']}), flat {off['ms']:.4f} ms (median turns; analytic "
        + " ".join(f"{r['ms']:.4f}" for r in turns["analytic"]) + ", flat "
        + " ".join(f"{r['ms']:.4f}" for r in turns["flat"]) + f"); plain loop {plain['ms']:.2f} "
        f"ms device / {plain['call_ms']:.2f} ms a call; bound {a_b_ms:.5f} ms ({a_b_by}: "
        f"{a_bytes} B, {a_ops} ops needed); ptxas {ptx}")


def phase_kernels() -> dict:
    rec = {"phys_substep": {}, "lstm_cell": {}, "seconds_by_check": {}}
    for check in (_check_phys, _check_phys_terrain, _check_phys_analytic, _check_phys_mpc,
                  _check_lstm, _check_lstm_rows, _check_lstm_training):
        t0 = time.perf_counter()
        check(rec)
        rec["seconds_by_check"][check.__name__] = time.perf_counter() - t0
    log("[3] seconds by check: " + ", ".join(f"{k.removeprefix('_check_')} {v:.1f}"
                                             for k, v in rec["seconds_by_check"].items()))
    return rec


# --- phases 4 and 5 -----------------------------------------------------------

def reset_counts() -> None:
    phys_cuda.launches = phys_cuda.analytic_launches = 0
    lstm_cuda.launches = lstm_cuda.train_launches = lstm_cuda.bwd_launches = 0
    lstm_cuda.rows_launches = 0


def read_counts() -> dict:
    """Every wrapper's launch count, by the kernel's name in the `kernels` line."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"phys_substep": phys_cuda.launches, "phys_analytic": phys_cuda.analytic_launches,
            "lstm_cell": lstm_cuda.launches,
            "lstm_seq_train": lstm_cuda.train_launches, "lstm_seq_bwd": lstm_cuda.bwd_launches,
            "lstm_cell_rows": lstm_cuda.rows_launches}


def check_counts(counts: dict, want: dict, what: str) -> None:
    """``want`` names the kernels launched; every other count must be 0."""
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{what}: launches {counts}, expected {want}")
    log(f"[{what}] launches: " + ", ".join(f"{k} {v}" for k, v in counts.items()))


def rollout_counts(steps: int) -> dict:
    """What an evaluation rollout of ``steps`` control steps launches: the
    physics and the inference LSTM kernels, and no training kernel."""
    return {"phys_substep": PHYS_LAUNCHES_PER_STEP * steps,
            "lstm_cell": LSTM_LAUNCHES_PER_STEP * steps, "lstm_seq_train": 0, "lstm_seq_bwd": 0}


def phase_serving() -> dict:
    argv = ["--model", ARTIFACT, "--eval", "--commands", "1,2,3,4,5",
            "--steps", str(EVAL_STEPS), "--device", DEVICE]
    reset_counts()
    t0 = time.perf_counter()
    res = cli_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, rollout_counts(EVAL_STEPS), "4")
    rows = res["tracking"]
    for r in rows:
        ref = JAX_V_MEAN[r["command"]]
        log(f"[4] cmd {r['command']:.1f}: v_mean {r['v_mean']:.4f} (JAX {ref:.4f}, "
            f"diff {r['v_mean'] - ref:+.4f}), falls {r['falls']}")
        if r["falls"]:
            raise RuntimeError(f"cmd {r['command']}: {r['falls']} falls")
        if not abs(r["v_mean"] - ref) <= V_TOL:
            raise RuntimeError(f"cmd {r['command']}: v_mean {r['v_mean']} vs JAX {ref}")
    env_steps = EVAL_STEPS * len(rows)
    log(f"[4] {EVAL_STEPS} control steps x {len(rows)} envs in {wall:.2f} s "
        f"(model load included): {env_steps / wall:.0f} env-steps/s, "
        f"{wall / EVAL_STEPS * 1e3:.3f} ms a control step")
    return {"rows": rows, "wall_s": wall, "env_steps_per_s": env_steps / wall,
            "launches": counts, "heads": heads_timing()}


def _sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def heads_timing() -> dict:
    """The policy heads of ``models/lstm.forward`` (2 x LSTM(48) -> 12 actions
    and 1 value) through ``lstm.row_product``, whose rows keep their bits at
    any batch width, against ``torch.matmul``, at the serving widths
    HEADS_WIDTHS: microseconds of wall a call of both heads, back to back
    with the card synchronized once after HEADS_REPS calls (what a
    host-bound loop pays), and the largest difference of the outputs."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)  # noqa: E731
    pi_w, pi_b, vf_w, vf_b = rand(48, 12), rand(12), rand(48, 1), rand(1)
    out = {}
    for b in HEADS_WIDTHS:
        pi_lat, v_lat = torch.tanh(rand(b, 48)), torch.tanh(rand(b, 48))
        rec = {}
        for name, product in (("matmul", torch.matmul), ("row_product", lstm.row_product)):
            def heads():
                return (product(pi_lat, pi_w) + pi_b, (product(v_lat, vf_w) + vf_b)[..., 0])
            for _ in range(20):
                heads()
            t0 = _sync(DEVICE)
            for _ in range(HEADS_REPS):
                heads()
            rec[f"{name}_us"] = (_sync(DEVICE) - t0) / HEADS_REPS * 1e6
            rec[f"{name}_out"] = heads()
        (m_pi, m_v), (r_pi, r_v) = rec.pop("matmul_out"), rec.pop("row_product_out")
        rec["max_abs_diff"] = max(float((m_pi - r_pi).abs().max()), float((m_v - r_v).abs().max()))
        out[b] = rec
        log(f"[4] policy heads at B={b}: row_product {rec['row_product_us']:.1f} us a call, "
            f"matmul {rec['matmul_us']:.1f} us; outputs within {rec['max_abs_diff']:.3g}")
    return out


def _kernel_device_ms(prof) -> dict:
    """Device time (ms) of the profiled window: all device events, and the
    two sources' kernels by name (phys_substep_kernel and
    phys_control_step_kernel; lstm_cell_kernel and lstm_cell_pair_kernel)."""
    out = {"phys_substep": 0.0, "lstm_cell": 0.0, "all": 0.0}
    for name, ms in device_events(prof):
        out["all"] += ms
        for k, prefix in (("phys_substep", "phys_"), ("lstm_cell", "lstm_cell_")):
            if prefix in name and "_kernel" in name:
                out[k] += ms
    return out


def ops_per_step_by_site(rollout, sites: dict) -> dict:
    """PyTorch (aten) ops the host dispatches a control step, by site: a 2-step
    ``rollout(n)`` less a 1-step one, with the calls counted inside each
    function of ``sites`` (name -> (module, attribute)) and in all ("total")."""
    per_n = []
    for n in (1, 2):
        tally = dict.fromkeys(sites, 0)
        with OpCounter() as oc:
            saved = {k: getattr(mod, name) for k, (mod, name) in sites.items()}

            def counted(key, fn):
                def run(*a, **kw):
                    before = oc.calls
                    try:
                        return fn(*a, **kw)
                    finally:
                        tally[key] += oc.calls - before
                return run
            try:
                for k, (mod, name) in sites.items():
                    setattr(mod, name, counted(k, saved[k]))
                rollout(n)
            finally:
                for k, (mod, name) in sites.items():
                    setattr(mod, name, saved[k])
        tally["total"] = oc.calls
        per_n.append(tally)
    return {k: per_n[1][k] - per_n[0][k] for k in per_n[0]}


def _torch_ops_by_site(cfg, params, cmds, gen) -> dict:
    """Ops a control step of the evaluation rollout inside the policy forward,
    step_batch's parts and, as the rest, the rollout's bookkeeping."""
    step = ops_per_step_by_site(
        lambda n: ev.policy_rollout(cfg, params, cmds, gen, n, device=DEVICE),
        {"policy": (lstm, "deterministic_action"), "step_batch": (bp, "step_batch"),
         "pre": (bp, "_pre_substeps"), "physics_call": (phys_cuda, "control_step"),
         "post": (bp, "_post_graphs")})
    return {"total": step["total"], "policy_forward": step["policy"],
            "step_batch_pre": step["pre"], "step_batch_physics_call": step["physics_call"],
            "step_batch_post": step["post"],
            "step_batch_glue": step["step_batch"] - step["pre"] - step["physics_call"]
            - step["post"],
            "rollout_bookkeeping": step["total"] - step["policy"] - step["step_batch"]}


def phase_full_width(params, kernel_ms: dict) -> dict:
    cfg = ev._fixed_command_cfg(config.test_default())
    cmds = np.stack([np.linspace(0.0, 5.0, FULL_B), np.zeros(FULL_B), np.zeros(FULL_B)], -1)
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    ev.policy_rollout(cfg, params, cmds[:8], gen, 2, device=DEVICE)   # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logr = ev.policy_rollout(cfg, params, cmds, gen, FULL_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, rollout_counts(FULL_STEPS), "5")
    for name in ("gc", "gv", "action", "obs", "lstm_state", "torque"):
        if not torch.isfinite(getattr(logr, name)).all():
            raise RuntimeError(f"non-finite {name} in the {FULL_B}-env rollout")
    falls = int(logr.done.sum())
    rate = FULL_B * FULL_STEPS / wall

    by_site = _torch_ops_by_site(cfg, params, cmds, gen)
    ops_per_step = by_site["total"]
    log(f"[5] PyTorch ops dispatched a control step: {ops_per_step} (first design "
        f"{PREV_TORCH_OPS_PER_STEP}): " + ", ".join(f"{k} {v}" for k, v in by_site.items()
                                                   if k != "total"))

    # per-kernel device time over a short profiled window
    prof_steps = PROF_STEPS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ev.policy_rollout(cfg, params, cmds, gen, prof_steps, device=DEVICE)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    dev = _kernel_device_ms(prof)
    if dev["all"] > 0:
        share = {k: dev[k] / prof_wall for k in ("phys_substep", "lstm_cell")}
        busy = dev["all"] / prof_wall
        src = f"torch.profiler over {prof_steps} steps"
    else:  # the profiler saw no device time: kernel times from phase 3's events
        share = {k: counts[k] * kernel_ms[k] / (wall * 1e3)
                 for k in ("phys_substep", "lstm_cell")}
        busy = None
        src = "phase-3 event times x launches (profiler saw no device time)"
    log(f"[5] {FULL_B} envs x {FULL_STEPS} control steps in {wall:.3f} s: {rate:.0f} env-steps/s, "
        f"{wall / FULL_STEPS * 1e3:.3f} ms a control step; falls {falls}; "
        f"{ops_per_step} PyTorch ops issued a control step "
        f"({wall / FULL_STEPS / ops_per_step * 1e6:.1f} us of wall each)")
    log(f"[5] share of wall time ({src}): phys_substep {share['phys_substep']:.3f}, "
        f"lstm_cell {share['lstm_cell']:.3f}, device busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'}")
    return {"wall_s": wall, "env_steps_per_s": rate, "falls": falls,
            "torch_ops_per_step": ops_per_step, "torch_ops_by_site": by_site,
            "launches": counts,
            "share": share, "device_busy": busy, "share_source": src,
            "profiled_device_ms": dev, "profiled_wall_ms": prof_wall}


# --- phases 6 and 7 -----------------------------------------------------------

class plain_lstm_layers:
    """Inside, models.lstm.sequence runs every layer through the plain cells
    under autograd, whatever the device."""

    def __enter__(self):
        self.saved = lstm_cuda.lstm_layer_sequence
        lstm_cuda.lstm_layer_sequence = lstm_cuda.lstm_layer_sequence_plain

    def __exit__(self, *exc):
        lstm_cuda.lstm_layer_sequence = self.saved


def _loss_and_grads(params, batch, ppo_cfg):
    for p in params.leaves():
        p.grad = None
    loss, aux = ppo.ppo_loss(params, batch, ppo_cfg)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), aux, {k: p.grad for k, p in params.named_leaves()}


def phase_bptt() -> dict:
    """ppo_loss and its gradients on a rollout's batch: kernels against plain."""
    env_cfg = config.from_yaml(TRAIN_CFG).replace(num_envs=FULL_B, use_lanes_physics=True)
    ppo_cfg = ppo.PPOConfig(n_steps=BPTT_STEPS)
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, env_cfg.seed, params, DEVICE)
    _, batch, _ = ppo.rollout(env_cfg, ppo_cfg, ts)
    _loss_and_grads(params, batch, ppo_cfg)   # warm-up: the first products of these shapes
    reset_counts()
    t0 = time.perf_counter()
    loss_k, aux_k, grads_k = _loss_and_grads(params, batch, ppo_cfg)
    kernel_s = time.perf_counter() - t0
    check_counts(read_counts(),
                       {"phys_substep": 0, "lstm_cell": 0, "lstm_seq_train": LSTM_LAYERS,
                        "lstm_seq_bwd": LSTM_LAYERS}, "6")
    reset_counts()
    with plain_lstm_layers():
        _loss_and_grads(params, batch, ppo_cfg)
        t0 = time.perf_counter()
        loss_p, aux_p, grads_p = _loss_and_grads(params, batch, ppo_cfg)
        plain_s = time.perf_counter() - t0
    check_counts(read_counts(), dict.fromkeys(
        ("phys_substep", "lstm_cell", "lstm_seq_train", "lstm_seq_bwd"), 0), "6 plain")
    torch.testing.assert_close(loss_k, loss_p, atol=1e-5, rtol=0)
    for k in aux_p:
        torch.testing.assert_close(aux_k[k], aux_p[k], atol=1e-5, rtol=0)
    rel = {}
    for k, g in grads_p.items():
        scale = float(g.abs().max())
        if not scale > 0:
            raise RuntimeError(f"phase 6: the plain gradient of {k} is zero")
        torch.testing.assert_close(grads_k[k], g, atol=GRAD_RTOL * scale, rtol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")
        rel[k] = float((grads_k[k] - g).abs().max()) / scale
    log(f"[6] ppo_loss on a {BPTT_STEPS}-step rollout at {FULL_B} envs: loss {float(loss_k):.6f} "
        f"(plain {float(loss_p):.6f}); every gradient leaf within {GRAD_RTOL:g} of its largest "
        f"entry (worst {max(rel.values()):.3g}, {max(rel, key=rel.get)}); loss + backward "
        f"{kernel_s * 1e3:.1f} ms through the kernels, {plain_s * 1e3:.1f} ms plain")
    return {"loss": float(loss_k), "loss_plain": float(loss_p), "grad_rel_err": rel,
            "kernel_s": kernel_s, "plain_s": plain_s}


def train_argv(updates: int, log_dir: str) -> list:
    """cli.train's arguments of phase 7: the flagship relaxed at 1024 envs."""
    return ["--cfg", TRAIN_CFG, "--load", ARTIFACT, "--lr", "5e-4", "--num-envs", str(FULL_B),
            "--max-updates", str(updates), "--log-dir", log_dir, "--device", DEVICE]


def phase_training() -> dict:
    """cli.train at 1024 envs x 750 steps x 10 epochs, then an update's parts."""
    argv = train_argv(TRAIN_UPDATES, TRAIN_LOG_DIR)
    env_cfg = config.from_yaml(TRAIN_CFG).replace(num_envs=FULL_B, use_lanes_physics=True)
    if env_cfg.episode_len != TRAIN_STEPS or ppo.PPOConfig().noptepochs != TRAIN_EPOCHS:
        raise RuntimeError("the training shape is not the production one")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_dir = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rollout_steps = TRAIN_UPDATES * TRAIN_STEPS
    sequences = TRAIN_UPDATES * TRAIN_EPOCHS   # one minibatch an epoch
    check_counts(counts, {
        "phys_substep": PHYS_LAUNCHES_PER_STEP * rollout_steps,
        # the rollout's steps and one bootstrap forward an update
        "lstm_cell": LSTM_LAUNCHES_PER_STEP * (rollout_steps + TRAIN_UPDATES),
        "lstm_seq_train": LSTM_LAYERS * sequences, "lstm_seq_bwd": LSTM_LAYERS * sequences}, "7")

    rows = metrics_io.read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    if len(rows) != TRAIN_UPDATES:
        raise RuntimeError(f"metrics.jsonl has {len(rows)} rows, expected {TRAIN_UPDATES}")
    for i, r in enumerate(rows):
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"update {i + 1}: non-finite metrics {bad}")
        if not r["loss_last_epoch"] < r["loss_first_epoch"]:
            raise RuntimeError(f"update {i + 1}: loss {r['loss_first_epoch']} in the first epoch, "
                               f"{r['loss_last_epoch']} in the last")
        log(f"[7] update {i + 1}: {r['time_rollout_s']:.2f} s rollout + {r['time_gae_s']:.3f} s "
            f"GAE + {r['time_epochs_s']:.2f} s for {TRAIN_EPOCHS} epochs; {r['fps']:.0f} "
            f"env-steps/s; loss {r['loss_first_epoch']:.5f} -> {r['loss_last_epoch']:.5f}; "
            f"reward/step {r['reward_per_step']:.4f}, approxkl {r['approxkl']:.2e}, "
            f"episodes ended {r['ep_count']:.0f}")

    for name in ("metrics.jsonl", "ckpt_final.pkl", "csv_final"):
        if not os.path.exists(os.path.join(run_dir, name)):
            raise RuntimeError(f"{run_dir} lacks {name}")
    # 17d: cli.train renders the curve board (JAX cli/train.py:159-165) with matplotlib, a
    # host-side figure; where the machine has none, the CLI prints why it skipped it, as JAX's
    dash = os.path.join(run_dir, "dashboard.png")
    if HAS_MATPLOTLIB:
        dash_bytes = os.path.getsize(dash) if os.path.exists(dash) else 0
        if dash_bytes < 10_000:
            raise RuntimeError(f"{dash} holds {dash_bytes} bytes")
        log(f"[7] [17d] {dash}: {dash_bytes} bytes")
    else:
        if os.path.exists(dash):
            raise RuntimeError(f"{dash} exists though this machine has no matplotlib")
        dash_bytes = None
        log("[7] [17d] dashboard.png not rendered: this machine has no matplotlib (the CPU "
            "tests render it, tests/test_torch_dashboard.py)")
    start = mio.policy_params_to_numpy(mio.load_bp5_csv(ARTIFACT, device=DEVICE))
    trained_p, adam, step = mio.load_checkpoint(os.path.join(run_dir, "ckpt_final.pkl"), DEVICE)
    trained = mio.policy_params_to_numpy(trained_p)
    from_csv = mio.policy_params_to_numpy(mio.load_bp5_csv(os.path.join(run_dir, "csv_final"), device=DEVICE))
    moved = {k: float(np.abs(trained[k] - start[k]).max()) for k in trained}
    if step != TRAIN_UPDATES or adam["count"] != TRAIN_UPDATES * TRAIN_EPOCHS:
        raise RuntimeError(f"checkpoint at update {step}, Adam step {adam['count']}")
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"parameters that did not change: {[k for k, v in moved.items() if not v]}")
    csv_err = max(float(np.abs(from_csv[k] - trained[k]).max()) for k in trained)
    if not csv_err <= 1e-6:
        raise RuntimeError(f"csv_final differs from the trained parameters by {csv_err}")
    log(f"[7] {TRAIN_UPDATES} updates in {wall:.1f} s; every parameter leaf changed (largest "
        f"move {max(moved.values()):.2e}); csv_final reloads within {csv_err:.1e}; peak device "
        f"memory {peak / 2 ** 30:.2f} GiB")

    # the same config under a freshly initialised policy: its rollout's reward, and on its
    # batch one epoch counted and one profiled
    ppo_cfg = ppo.PPOConfig(learning_rate=5e-4, n_steps=TRAIN_STEPS)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, env_cfg.seed, None, DEVICE)
    ts, batch, _ = ppo.rollout(env_cfg, ppo_cfg, ts)
    fresh_reward = float(batch.rewards.mean())
    if not rows[0]["reward_per_step"] > fresh_reward:
        raise RuntimeError(f"the loaded policy's first rollout earned {rows[0]['reward_per_step']} "
                           f"a step, a fresh policy {fresh_reward}")
    log(f"[7] reward a step in the first rollout {rows[0]['reward_per_step']:.4f}, of a freshly "
        f"initialised policy on the same config {fresh_reward:.4f}")
    step_ops = []   # PyTorch ops a control step of the training rollout: 2 steps less 1
    for n_steps in (1, 2):
        with OpCounter() as oc:
            ppo.rollout(env_cfg, ppo.PPOConfig(n_steps=n_steps), ts)
        step_ops.append(oc.calls)
    rollout_ops_per_step = step_ops[1] - step_ops[0]
    mean_step_ms = float(np.mean([r["time_rollout_s"] for r in rows])) / TRAIN_STEPS * 1e3
    log(f"[7] the training rollout dispatches {rollout_ops_per_step} PyTorch ops a control step "
        f"(the evaluation rollout: see [5]); {mean_step_ms:.2f} ms a control step, "
        f"{mean_step_ms / rollout_ops_per_step * 1e3:.1f} us of wall an op")
    ppo.train_minibatch(ts.params, ts.opt_state, batch, ppo_cfg)   # warm-up
    with OpCounter() as oc:
        ppo.train_minibatch(ts.params, ts.opt_state, batch, ppo_cfg)
    torch.cuda.synchronize()
    # in this long-lived process the profiler drops the sequence forward's events from the
    # epoch's window, with or without the host's activity (a fresh process keeps them): a
    # window that lacks a kernel is taken again, and a kernel never seen is not measured
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            ppo.train_minibatch(ts.params, ts.opt_state, batch, ppo_cfg)
            torch.cuda.synchronize()
            epoch_ms = (time.perf_counter() - t1) * 1e3
        dev = _kernel_device_ms(prof)
        by_kernel = {"lstm_seq_train": 0.0, "lstm_seq_bwd": 0.0}
        for name, ms in device_events(prof):
            for k in by_kernel:
                if f"{k}_kernel" in name:
                    by_kernel[k] += ms
        if all(by_kernel.values()):
            break
    by_kernel = {k: v or None for k, v in by_kernel.items()}
    # a window that lacks a kernel's events lacks device time: its total is not measured
    device_ms = dev["all"] if all(by_kernel.values()) and dev["all"] > 0 else None
    busy = None if device_ms is None else device_ms / epoch_ms
    other = None if device_ms is None else device_ms - sum(by_kernel.values())
    log(f"[7] one epoch (loss, BPTT over {TRAIN_STEPS} steps, clip, Adam): {epoch_ms:.1f} ms under "
        f"the profiler, {oc.calls} PyTorch ops; device busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'} of it: "
        + ", ".join(f"{k} {'not measured' if v is None else f'{v:.1f} ms'}"
                    for k, v in by_kernel.items())
        + f", other device work {'not measured' if other is None else f'{other:.1f} ms'}")
    return {"run_dir": os.path.relpath(run_dir, ROOT), "wall_s": wall, "updates": rows,
            "launches": counts, "peak_memory_bytes": peak, "largest_move": max(moved.values()),
            "csv_err": csv_err, "fresh_policy_reward_per_step": fresh_reward,
            "rollout_torch_ops_per_step": rollout_ops_per_step,
            "epoch_ms_profiled": epoch_ms, "torch_ops_per_epoch": oc.calls,
            "epoch_device_busy": busy, "epoch_device_ms": device_ms,
            "epoch_kernel_ms": by_kernel, "dashboard_png_bytes": dash_bytes,
            "dashboard": "rendered" if HAS_MATPLOTLIB else "not rendered: no matplotlib"}


# --- phases 8 to 12 ---------------------------------------------------------------

def riccati_flops(nx: int = srb.NX, nu: int = srb.NU) -> int:
    """Operations of one knot of the dense affine Riccati sweep and forward
    rollout, counted by hand (a multiply-add two): V A, V B, B'VB, B'VA, B'v,
    the Cholesky factorization of Quu and its solve for the 1 + nx columns of
    [qu | Qux], A'VA, Qux'K, A'v, Qux'k, the sums and the symmetrization; then
    K x, A x and B f."""
    products = 2 * (nx * nx * nx + nx * nx * nu + nu * nx * nu + nu * nx * nx + nu * nx
                    + nx * nx * nx + nx * nu * nx + nx * nx + nx * nu)
    chol = nu ** 3 // 3 + 2 * nu * nu * (1 + nx)
    sums = 4 * nx * nx + 3 * nx + 2 * nu * nu + nu
    forward = 2 * (nu * nx + nx * nx + nx * nu) + 3 * nx + 6 * 4
    return products + chol + sums + forward


def srb_bench_problems(cfg, batch: int = SRB_BATCH, device=DEVICE) -> srb.SRBProblem:
    """bench.py's problems: commands 1-5 m/s over 17 values, gait clocks 3 ms
    apart."""
    i = np.arange(batch)
    cmds = np.stack([1.0 + 4.0 * (i % 17) / 16.0, 0.0 * i, 0.0 * i], -1).astype(np.float32)
    t0s = i.astype(np.float32) * np.float32(0.003)
    return srb.standing_problem(cfg, torch.tensor(cmds, device=device),
                                torch.tensor(t0s, device=device))


def phase_batched_solve() -> dict:
    """srb.batched_solve at the JAX package's bench shape against its CPU
    results, then its rate, host ops, busy share, memory and bound."""
    cfg = config.test_default()
    scfg = srb.SRBConfig(horizon=SRB_HORIZON)
    probs = srb_bench_problems(cfg)
    run = lambda: srb.batched_solve(cfg, scfg, probs)  # noqa: E731
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    check_counts(read_counts(), dict.fromkeys(
        ("phys_substep", "lstm_cell", "lstm_seq_train", "lstm_seq_bwd"), 0), "8")
    for name in ("forces", "xs", "us", "cost"):
        if not torch.isfinite(getattr(res, name)).all():
            raise RuntimeError(f"non-finite {name} in the batched solve")
    cost = res.cost.double()
    got = {"mean": float(cost.mean()), "min": float(cost.min()), "max": float(cost.max())}
    for k, want in JAX_SRB_COST.items():
        rtol = SRB_COST_MEAN_RTOL if k == "mean" else SRB_COST_EXTREME_RTOL
        if not abs(got[k] - want) <= rtol * want:
            raise RuntimeError(f"batched solve: cost {k} {got[k]} vs JAX {want}")
    kept = torch.ones(SRB_BATCH, dtype=torch.bool, device=DEVICE)
    kept[JAX_SRB_BOUNDARY] = False
    chunks = (cost * kept).reshape(len(JAX_SRB_CHUNK_SUMS), -1).sum(dim=1)
    chunk_rel = (chunks / torch.tensor(JAX_SRB_CHUNK_SUMS, dtype=torch.float64,
                                       device=DEVICE) - 1).abs()
    if not bool((chunk_rel <= SRB_CHUNK_RTOL).all()):
        raise RuntimeError(f"batched solve: cost sums of 1024 problems off JAX's by "
                           f"{chunk_rel.tolist()} relative")
    ref = torch.tensor(JAX_SRB_ROWS, dtype=torch.float32, device=DEVICE)
    n = ref.shape[0]
    f, us = res.forces[:n].reshape(n, SRB_HORIZON, 12), res.us[:n]
    torch.testing.assert_close(res.cost[:n], ref[:, 0], atol=0, rtol=SRB_ROW_RTOL)
    torch.testing.assert_close(f[:, 0], ref[:, 1:13], atol=SRB_FORCE_ATOL, rtol=0)
    torch.testing.assert_close(us[:, 0], ref[:, 13:25], atol=SRB_US_ATOL, rtol=0)
    torch.testing.assert_close(torch.linalg.vector_norm(f.reshape(n, -1), dim=1), ref[:, 25],
                               atol=SRB_FORCE_ATOL, rtol=SRB_ROW_RTOL)
    torch.testing.assert_close(torch.linalg.vector_norm(us.reshape(n, -1), dim=1), ref[:, 26],
                               atol=SRB_US_ATOL, rtol=SRB_ROW_RTOL)
    err = {"forces": float((f[:, 0] - ref[:, 1:13]).abs().max()),
           "us": float((us[:, 0] - ref[:, 13:25]).abs().max()),
           "cost_rel": float(((res.cost[:n] - ref[:, 0]).abs() / ref[:, 0]).max()),
           "mean_rel": abs(got["mean"] / JAX_SRB_COST["mean"] - 1),
           "chunk_sum_rel": float(chunk_rel.max())}
    log(f"[8] batched solve {SRB_BATCH} x h{SRB_HORIZON}: cost mean {got['mean']:.9g} (JAX "
        f"{JAX_SRB_COST['mean']:.9g}), min {got['min']:.9g}, max {got['max']:.9g}; sums of "
        f"1024 costs ({len(JAX_SRB_BOUNDARY)} on a phase boundary left out) within "
        f"{err['chunk_sum_rel']:.3g} relative; first {n} problems: forces max |err| "
        f"{err['forces']:.3g} N, us {err['us']:.3g}, cost {err['cost_rel']:.3g} relative")

    walls = []
    for _ in range(SRB_REPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(walls)
    with OpCounter() as oc:
        run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    dev_ms = _kernel_device_ms(prof)["all"]
    busy = dev_ms / prof_ms if dev_ms > 0 else None
    flops = SRB_BATCH * SRB_HORIZON * riccati_flops()
    nbytes = 4 * SRB_BATCH * (20 + SRB_HORIZON * 12 + (SRB_HORIZON + 1) * 13 + SRB_HORIZON * 12 + 1)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"[8] batched solve: {ms:.2f} ms a call (median of {SRB_REPS}; min {min(walls):.2f}), "
        f"{SRB_BATCH / ms * 1e3:.0f} solves/s; {oc.calls} PyTorch ops a call; device busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'} ({dev_ms / 3:.2f} ms of device "
        f"time a call); peak memory {peak / 2 ** 20:.0f} MiB; bound {b_ms:.4f} ms ({b_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "ms_all": walls, "solves_per_s": SRB_BATCH / ms, "torch_ops": oc.calls,
            "device_busy": busy, "device_ms_per_call": dev_ms / 3, "peak_memory_bytes": peak,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
            "cost": got, "err": err}


class _SyncedTimers:
    """Wall time spent inside each function of ``sites`` (name -> (module,
    attribute)), with the device synchronized around each call, while the
    ``with`` block runs: ``acc`` holds seconds by name."""

    def __init__(self, sites: dict):
        self.sites, self.acc = sites, dict.fromkeys(sites, 0.0)

    def __enter__(self):
        self.saved = {k: getattr(mod, name) for k, (mod, name) in self.sites.items()}

        def timed(key, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    self.acc[key] += time.perf_counter() - t0
            return run
        for k, (mod, name) in self.sites.items():
            setattr(mod, name, timed(k, self.saved[k]))
        return self.acc

    def __exit__(self, *exc):
        for k, (mod, name) in self.sites.items():
            setattr(mod, name, self.saved[k])


def phase_mpc() -> dict:
    """cli.mpc --engine srb at commands 1-5, held to the JAX package: within
    V_TOL of its per-env loop with its falls, and within MPC_LANES_TOL of the
    same loop through its lanes physics. The solve and the env step are timed
    in the same run, the device synchronized around each of their calls."""
    cmds = [float(c) for c in MPC_COMMANDS.split(",")]
    batches = cli_mpc.schedule_batches(config.test_default(), cmds)
    groups = len(batches)
    argv = ["--engine", "srb", "--commands", MPC_COMMANDS, "--steps", str(MPC_STEPS),
            "--device", DEVICE]
    sites = {"solve": (srb, "solve"), "env_step": (bp, "step_batch")}
    reset_counts()
    with _SyncedTimers(sites) as acc:
        t0 = time.perf_counter()
        res = cli_mpc.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, {"phys_substep": PHYS_LAUNCHES_PER_STEP * MPC_STEPS * groups,
                          "lstm_cell": 0, "lstm_seq_train": 0, "lstm_seq_bwd": 0}, "9")
    failed = []
    for r in res["rows"]:
        v_ref, falls_ref = JAX_MPC_V_FALLS[r["command"]]
        v_lanes = JAX_MPC_LANES_V[r["command"]]
        log(f"[9] cmd {r['command']:.1f}: v {r['v_mean']:.4f} (JAX {v_ref:.4f}, diff "
            f"{r['v_mean'] - v_ref:+.4f}; JAX on its lanes physics {v_lanes:.4f}, diff "
            f"{r['v_mean'] - v_lanes:+.4f}), falls {r['falls']} (JAX {falls_ref}), solve cost "
            f"{r['solve_cost']:.5f}, T={r['period']:.2f} s lam={r['lam']:.2f}")
        if (not abs(r["v_mean"] - v_ref) <= V_TOL or r["falls"] != falls_ref
                or not abs(r["v_mean"] - v_lanes) <= MPC_LANES_TOL):
            failed.append(r["command"])
    if failed:
        raise RuntimeError(f"closed loop: commands {failed} miss the JAX speed by more than "
                           f"{V_TOL} m/s, its lanes-physics speed by more than {MPC_LANES_TOL} "
                           "m/s, or differ in falls")
    n = MPC_STEPS * groups
    ms = {k: v / n * 1e3 for k, v in acc.items()}
    ms["total"] = wall / n * 1e3
    ms["rest"] = ms["total"] - ms["solve"] - ms["env_step"]
    (env_cfg, scfg, kwargs), vxs = next(iter(batches.items()))
    batch = np.array([[vx, 0.0, 0.0] for vx in vxs], np.float32)
    gen = torch.Generator(device=DEVICE)
    ops = ops_per_step_by_site(lambda k: mpc_runtime.mpc_rollout(
        env_cfg, scfg, batch, gen, k, device=DEVICE, **dict(kwargs)), sites)
    ops["rest"] = ops["total"] - ops["solve"] - ops["env_step"]
    log(f"[9] {MPC_STEPS} control steps x {groups} schedule batches in {wall:.1f} s: "
        f"{ms['total']:.2f} ms a control step of a batch (device synchronized around each "
        "solve and env step): " + ", ".join(f"{k} {ms[k]:.2f} ms" for k in
                                            ("solve", "env_step", "rest")))
    log(f"[9] PyTorch ops a control step of the batch of cmd "
        f"{','.join(f'{v:g}' for v in batch[:, 0])}: " + ", ".join(
            f"{k} {ops[k]}" for k in ("solve", "env_step", "rest", "total")))
    return {"rows": res["rows"], "wall_s": wall, "ms_per_step": ms["total"], "groups": groups,
            "launches": counts, "split": {"ms": ms, "ops": ops}}


def phase_terrain_eval() -> dict:
    """The terrain policy at cmd 1-3 x JAX's 8 map offsets, one batch of 24
    envs, against the JAX lanes loop: base coordinates after 50 and 100
    steps, the mean speed over the offsets and the falls of each command."""
    cfg = ev._fixed_command_cfg(config.from_yaml(TERRAIN_CFG)).replace(crucial=False)
    params = mio.load_bp5_csv(TERRAIN_EVAL_ARTIFACT, device=DEVICE)
    cmd_of = [vx for vx in TERRAIN_COMMANDS for _ in range(TERRAIN_K)]
    cmds = np.array([[vx, 0.0, 0.0] for vx in cmd_of], np.float32)
    offsets = torch.tensor(JAX_TERRAIN_OFFSETS * len(TERRAIN_COMMANDS), dtype=torch.float32,
                           device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    ev.policy_rollout(cfg, params, cmds, gen, 2, device=DEVICE, terrain_offset=offsets)  # warm-up
    reset_counts()
    t0 = time.perf_counter()
    logr = ev.policy_rollout(cfg, params, cmds, gen, TERRAIN_STEPS, device=DEVICE,
                             terrain_offset=offsets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, rollout_counts(TERRAIN_STEPS), "10")
    for name in ("gc", "gv", "action", "lstm_state"):
        if not torch.isfinite(getattr(logr, name)).all():
            raise RuntimeError(f"non-finite {name} in the terrain rollout")
    rows = ev.tracking_rows(cfg, logr, cmd_of)
    want_base = np.array(JAX_TERRAIN_BASE).reshape(len(cmd_of), 2, 7)
    got_base = torch.stack([logr.gc[49, :, :7], logr.gc[99, :, :7]], 1).cpu().numpy()
    base_err = np.abs(got_base - want_base).max(axis=(1, 2))
    failed = [f"cmd {cmd_of[b]:g} offset {b % TERRAIN_K}: base off by {base_err[b]:.3g}"
              for b in range(len(cmd_of)) if not base_err[b] <= TERRAIN_BASE_ATOL]
    by_cmd = {}
    for i, vx in enumerate(TERRAIN_COMMANDS):
        mine = rows[i * TERRAIN_K:(i + 1) * TERRAIN_K]
        want_v, want_falls = JAX_TERRAIN_LANES[vx]
        v, falls = [r["v_mean"] for r in mine], sum(r["falls"] for r in mine)
        by_cmd[vx] = {"v": v, "v_mean": float(np.mean(v)), "v_std": float(np.std(v)),
                      "falls": falls, "jax_v": want_v, "jax_v_mean": float(np.mean(want_v)),
                      "jax_falls": want_falls,
                      "base_err": float(base_err[i * TERRAIN_K:(i + 1) * TERRAIN_K].max())}
        log(f"[10] cmd {vx:.1f}: v {np.mean(v):.4f} +- {np.std(v):.4f} over {TERRAIN_K} offsets "
            f"(JAX lanes {np.mean(want_v):.4f} +- {np.std(want_v):.4f}, diff "
            f"{np.mean(v) - np.mean(want_v):+.4f}), falls {falls} (JAX {want_falls}); base after "
            f"50/100 steps within {by_cmd[vx]['base_err']:.2g}; by offset "
            + " ".join(f"{a:.3f}/{b:.3f}" for a, b in zip(v, want_v)))
        if not abs(np.mean(v) - np.mean(want_v)) <= V_TOL or falls != want_falls:
            failed.append(f"cmd {vx:g}: v {np.mean(v)} against JAX {np.mean(want_v)}, falls "
                          f"{falls} against {want_falls}")
    if failed:
        raise RuntimeError("terrain evaluation: " + "; ".join(failed))
    log(f"[10] {TERRAIN_STEPS} control steps x {len(cmd_of)} envs in {wall:.2f} s: "
        f"{len(cmd_of) * TERRAIN_STEPS / wall:.0f} env-steps/s, "
        f"{wall / TERRAIN_STEPS * 1e3:.3f} ms a control step")
    return {"by_command": by_cmd, "wall_s": wall, "ms_per_step": wall / TERRAIN_STEPS * 1e3,
            "launches": counts}


def phase_terrain_training() -> dict:
    """cli.train on terrain with the round-5 leg's flags and the z-scale
    curriculum at the production shape, then its checkpoint through cli.test."""
    argv = ["--cfg", TERRAIN_CFG, "--load", TERRAIN_TRAIN_ARTIFACT, "--num-envs", str(FULL_B),
            "--lr", "1e-4", "--lr-final", "2e-5", "--entropy-floor", "5.2",
            "--terrain-z-curriculum", ",".join(str(z) for z in TERRAIN_Z),
            "--max-updates", str(TERRAIN_TRAIN_UPDATES), "--log-dir", TERRAIN_TRAIN_LOG_DIR,
            "--device", DEVICE]
    env_cfg = config.from_yaml(TERRAIN_CFG).replace(num_envs=FULL_B, use_lanes_physics=True)
    if env_cfg.episode_len != TRAIN_STEPS or not env_cfg.terrain:
        raise RuntimeError("the terrain training shape is not the production one")
    reset_counts()
    t0 = time.perf_counter()
    run_dir = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rollout_steps = TERRAIN_TRAIN_UPDATES * TRAIN_STEPS
    sequences = TERRAIN_TRAIN_UPDATES * TRAIN_EPOCHS
    check_counts(counts, {
        "phys_substep": PHYS_LAUNCHES_PER_STEP * rollout_steps,
        "lstm_cell": LSTM_LAUNCHES_PER_STEP * (rollout_steps + TERRAIN_TRAIN_UPDATES),
        "lstm_seq_train": LSTM_LAYERS * sequences, "lstm_seq_bwd": LSTM_LAYERS * sequences}, "11")
    rows = metrics_io.read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    if len(rows) != TERRAIN_TRAIN_UPDATES:
        raise RuntimeError(f"metrics.jsonl has {len(rows)} rows, expected {TERRAIN_TRAIN_UPDATES}")
    for i, (r, z) in enumerate(zip(rows, TERRAIN_Z)):
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"terrain update {i}: non-finite metrics {bad}")
        if not abs(r["terrain_z_scale"] - z) <= 1e-6:
            raise RuntimeError(f"terrain update {i}: z_scale {r['terrain_z_scale']}, expected {z}")
        log(f"[11] update {i}: z_scale {r['terrain_z_scale']:.4f}; {r['time_rollout_s']:.2f} s "
            f"rollout + {r['time_gae_s']:.3f} s GAE + {r['time_epochs_s']:.2f} s for "
            f"{TRAIN_EPOCHS} epochs; {r['fps']:.0f} env-steps/s; loss {r['loss']:.5f}, gradient "
            f"norm {r['grad_norm']:.4g}, entropy {r['entropy']:.3f}, reward/step "
            f"{r['reward_per_step']:.4f}, episodes ended {r['ep_count']:.0f}")
    ckpt = os.path.join(run_dir, "ckpt_final.pkl")
    params, _, step = mio.load_checkpoint(ckpt, DEVICE)
    if step != TERRAIN_TRAIN_UPDATES or not all(
            torch.isfinite(p).all() for p in params.leaves()):
        raise RuntimeError(f"{ckpt}: update {step}, or non-finite parameters")
    res = cli_test.main(["--model", ckpt, "--cfg", TERRAIN_CFG, "--eval", "--commands", "1,2,3",
                         "--steps", "200", "--device", DEVICE])
    if not all(np.isfinite(r["v_mean"]) for r in res["tracking"]):
        raise RuntimeError(f"cli.test on the terrain checkpoint: {res['tracking']}")
    log(f"[11] {TERRAIN_TRAIN_UPDATES} updates in {wall:.1f} s; cli.test --model "
        f"{os.path.relpath(ckpt, ROOT)} on the terrain config: "
        + ", ".join(f"cmd {r['command']:g} v {r['v_mean']:+.3f}" for r in res["tracking"]))
    ppo_cfg = ppo.PPOConfig(n_steps=TRAIN_STEPS)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, env_cfg.seed, params, DEVICE)
    step_ops = []   # PyTorch ops a control step of the terrain training rollout: 2 steps less 1
    for n_steps in (1, 2):
        with OpCounter() as oc:
            ppo.rollout(env_cfg, ppo.PPOConfig(n_steps=n_steps), ts)
        step_ops.append(oc.calls)
    ops_per_step = step_ops[1] - step_ops[0]
    mean_step_ms = float(np.mean([r["time_rollout_s"] for r in rows])) / TRAIN_STEPS * 1e3
    log(f"[11] the terrain training rollout dispatches {ops_per_step} PyTorch ops a control step "
        f"(flat: {FLAT_TRAIN_OPS_PER_STEP}); {mean_step_ms:.2f} ms a control step")
    return {"run_dir": os.path.relpath(run_dir, ROOT), "wall_s": wall, "updates": rows,
            "launches": counts, "rollout_torch_ops_per_step": ops_per_step,
            "ms_per_rollout_step": mean_step_ms, "cli_test": res["tracking"]}


def phase_parity(params) -> dict:
    """srb_vs_bp5 at cmd 1 on the flagship artifact against the JAX package's."""
    reset_counts()
    res = parity.srb_vs_bp5(config.test_default(), params, 1.0, device=DEVICE)
    counts = read_counts()
    steps = 200 + 50 + 1
    check_counts(counts, {**rollout_counts(steps)}, "12")
    got = {k: res[k] for k in ("mae", "mae_stance", "mae_swing")}
    for k, want in JAX_SRB_VS_BP5.items():
        log(f"[12] srb_vs_bp5 cmd 1: {k} {got[k]:.5f} (JAX {want:.5f}, diff {got[k] - want:+.2g})")
        if not abs(got[k] - want) <= SRB_VS_BP5_ATOL:
            raise RuntimeError(f"srb_vs_bp5 {k}: {got[k]} vs JAX {want}")
    return {**got, "launches": counts}


# --- phase 13 -----------------------------------------------------------------

class _GraphedPlainSubstep:
    """Inside, ``phys_cuda.substep`` is the plain ``phys_lanes.substep``
    replayed from a CUDA graph (``ilqr.Replayed``, one a lane width and
    parameter set): the same kernels as the plain function without its ~27k
    host dispatches a call (0.2-0.4 s eager, which would make a plain solve's
    900 substeps take minutes)."""

    def __enter__(self):
        self.saved, self.graphs = phys_cuda.substep, {}
        phys_cuda.substep = self._call
        return self

    def __exit__(self, *exc):
        phys_cuda.substep = self.saved
        self.graphs.clear()

    def _call(self, P, gcT, gvT, tauT, bwT, slip, imp, dt):
        key = (id(P), slip, imp, dt)
        if key not in self.graphs:
            self.graphs[key] = (ilqr.Replayed(
                lambda *rows: lanes.substep(P, *rows, slip, imp, dt)), P)
        return self.graphs[key][0](gcT, gvT, tauT, bwT)


WB_SITES = {"rollout": (ilqr, "_rollout"), "linearize": (ilqr, "_linearize"),
            "cost_derivatives": (ilqr, "_quadratize"),
            "terminal_derivatives": (ilqr, "_quadratize_terminal"),
            "riccati": (ilqr, "_backward"), "line_search": (ilqr, "_line_search"),
            "step_size_pick": (ilqr, "_accept")}


def wb_flops(linearizer: str, lanes_physics: bool, B: int = WB_BATCH, T: int = WB_HORIZON,
             n_iter: int = WB_ITERS, n_alphas: int = 8, n: int = 37, m: int = 12,
             relin_every: int = 1) -> int:
    """Operations a bench-shape solve needs at least, counted from the code
    (a multiply-add two): every control-step evaluation of the physics (2
    substeps after the PD law and clamp: the rollout, n_alphas line-search
    rollouts an iteration and, with FD Jacobians, 2 (n + m) perturbed ones a
    knot; phys_ops_per_env), the Riccati knot with its gains
    (riccati_flops(n, m)) and, with the frozen linearizer, its matrix algebra:
    the 18 x 18 inverse (n^3 / 3 for the factor, 2 n^3 for the two solves
    against the identity) and one 18 x 18 matrix-vector product a tangent and
    substep for the n + m tangents, on each iteration that relinearizes (every
    ``relin_every``-th). The cost's derivatives and the surrogate's
    kinematics are left out (a lower bound)."""
    evals = B * T * (1 + n_iter * n_alphas)
    if linearizer == "fd":
        evals += B * T * n_iter * 2 * (n + m)
    ops = evals * phys_ops_per_env(2, pd_law=True) + B * T * n_iter * riccati_flops(n, m)
    if linearizer == "frozen":
        nv = 18
        relins = -(-n_iter // relin_every)
        ops += B * T * relins * (nv ** 3 // 3 + 2 * nv ** 3 + (n + m) * 2 * 2 * nv * nv)
    return ops


def _repeats_identical(res) -> bool:
    """Every repeat of each distinct problem solved bit for bit alike."""
    for r in range(WB_DISTINCT):
        idx = torch.arange(r, WB_BATCH, WB_DISTINCT, device=DEVICE)
        for x in (res.us, res.xs, res.cost_trace):
            if not torch.equal(x[idx], x[idx[:1]].expand_as(x[idx])):
                return False
    return True


def _wb_distinct(cost: torch.Tensor) -> list[float]:
    return [float(c) for c in cost[:WB_DISTINCT].double()]


def _wb_measure(name: str, run, launches_per_solve: int) -> dict:
    """The checked call with its op count and launches, then WB_REPS timed
    calls, then one profiled call timed by solver phase (the device synced
    around each): returns the checked call's result and the record."""
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with OpCounter() as oc:
        res = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    counts = read_counts()
    check_counts(counts, {"phys_substep": launches_per_solve, "lstm_cell": 0,
                          "lstm_seq_train": 0, "lstm_seq_bwd": 0}, f"13 {name}")
    for f in ("us", "xs", "cost", "cost_trace"):
        if not torch.isfinite(getattr(res, f)).all():
            raise RuntimeError(f"phase 13 {name}: non-finite {f}")
    trace = res.cost_trace.double()
    if not bool((trace[:, 1:] <= trace[:, :-1] * (1 + 1e-6)).all()):
        raise RuntimeError(f"phase 13 {name}: a cost trace rises")
    if not _repeats_identical(res):
        raise RuntimeError(f"phase 13 {name}: repeats of a problem differ")
    walls = []
    for _ in range(WB_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(walls)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with _SyncedTimers(WB_SITES) as split:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t1) * 1e3
    dev = _kernel_device_ms(prof)
    busy = dev["all"] / prof_ms if dev["all"] > 0 else None
    phase_ms = {k: v * 1e3 for k, v in split.items() if v > 0}
    phase_ms["rest"] = prof_ms - sum(phase_ms.values())
    return res, {"ms": ms, "ms_all": walls, "solves_per_s": WB_BATCH / ms * 1e3,
                 "torch_ops": oc.calls, "launches": counts, "peak_memory_bytes": peak,
                 "device_busy": busy, "device_ms": dev["all"], "profiled_ms": prof_ms,
                 "phys_kernel_device_ms": dev["phys_substep"],
                 "phys_kernel_share": dev["phys_substep"] / dev["all"] if dev["all"] else None,
                 "ms_by_phase_profiled_call": phase_ms}


def _wb_log(name: str, r: dict, flops: int) -> None:
    # bytes: x0, the joint and joint-rate references, the terminal reference and the
    # command in; us, xs, the cost and its trace out
    nbytes = 4 * WB_BATCH * ((37 + 2 * WB_HORIZON * 12 + 12 + 3)
                             + (WB_HORIZON * 12 + (WB_HORIZON + 1) * 37 + 1 + WB_ITERS))
    b_ms, b_by = bound_ms(nbytes, flops)
    r.update(bound_ms=b_ms, bound_by=b_by, flops=flops)
    split = ", ".join(f"{k} {v:.0f}" for k, v in sorted(r["ms_by_phase_profiled_call"].items(),
                                                       key=lambda kv: -kv[1]))
    busy, share = r["device_busy"], r["phys_kernel_share"]
    log(f"[13] {name}: {r['ms']:.0f} ms a call (median of {WB_REPS}; {min(r['ms_all']):.0f}-"
        f"{max(r['ms_all']):.0f}), {r['solves_per_s']:.2f} solves/s; {r['torch_ops']} PyTorch "
        f"ops a call; device busy {'not measured' if busy is None else f'{busy:.4f}'} "
        f"({r['device_ms']:.1f} ms of device time in a {r['profiled_ms']:.0f} ms profiled call), "
        f"substep kernel {'-' if share is None else f'{share:.3f}'} of it; peak memory "
        f"{r['peak_memory_bytes'] / 2 ** 20:.1f} MiB; bound {b_ms:.4f} ms ({b_by}: "
        f"{flops / 1e9:.3f} GFLOP); ms of the profiled call by solver phase: {split}")


def _nudged(probs, dz: float):
    """The problems with the start height raised by ``dz`` metres."""
    return probs._replace(x0=probs.x0 + dz * torch.eye(37, device=DEVICE)[2])


def _wb_nudge(name: str, r: dict, solve, probs) -> None:
    """Record how far the solve's distinct final costs move when the start is
    WB_NUDGE_M higher."""
    r["nudge_cost"] = _wb_distinct(solve(_nudged(probs, WB_NUDGE_M)).cost)
    r["nudge_rel"] = [abs(g / w - 1) for g, w in zip(r["nudge_cost"], r["cost"])]
    log(f"[13] {name}: the start {WB_NUDGE_M:g} m higher moves the final costs by "
        f"{[round(x, 5) for x in r['nudge_rel']]} ({[round(c, 3) for c in r['nudge_cost']]})")


def _check_fd_jacobians(cfg, mc, params, states: dict) -> dict:
    """Central-FD Jacobians of one control step (fd_eps of ``mc``) through the
    substep kernel and through the plain substep in float32 and float64 (both
    replayed), at the states of each (xs (B, T+1, 37), us (B, T, 12)) of
    ``states``' distinct problems: the kernel's relative error per state
    against float64 within WB_JAC_RTOL_MEDIAN (median) and WB_JAC_RTOL_MAX."""
    jac = lambda dyn, X, U: torch.cat(ilqr._jacobian_fd(dyn, X, U, mc.fd_eps), -1)  # noqa: E731
    out = {}
    for name, (xs, us) in states.items():
        X = xs[:WB_DISTINCT, :-1].reshape(-1, 37)
        U = us[:WB_DISTINCT].reshape(-1, 12)
        jk = jac(trot.make_dynamics_batch(cfg, mc, params), X, U)
        with _GraphedPlainSubstep():
            jp = jac(trot.make_dynamics_batch(cfg, mc, params), X, U)
            j64 = jac(trot.make_dynamics_batch(cfg, mc, params.map(lambda t: t.double())),
                      X.double(), U.double())
        norm = j64.norm(dim=(-2, -1))
        rel_k = ((jk.double() - j64).norm(dim=(-2, -1)) / norm).cpu()
        rel_p = ((jp.double() - j64).norm(dim=(-2, -1)) / norm).cpu()
        rec = {"states": int(X.shape[0]), "kernel_median": float(rel_k.median()),
               "kernel_max": float(rel_k.max()), "plain_median": float(rel_p.median()),
               "plain_max": float(rel_p.max())}
        log(f"[13] FD Jacobians at the {name} states ({rec['states']}, {X.shape[0] * 98} lanes): "
            f"relative error against the plain substep in float64, kernel median "
            f"{rec['kernel_median']:.3g} max {rec['kernel_max']:.3g}, plain float32 median "
            f"{rec['plain_median']:.3g} max {rec['plain_max']:.3g} (limits {WB_JAC_RTOL_MEDIAN:g}, "
            f"{WB_JAC_RTOL_MAX:g})")
        if not (bool(torch.isfinite(jk).all()) and rec["kernel_median"] <= WB_JAC_RTOL_MEDIAN
                and rec["kernel_max"] <= WB_JAC_RTOL_MAX):
            raise RuntimeError(f"phase 13: the kernel's FD Jacobians at the {name} states: {rec}")
        out[name] = rec
    return out


def phase_wholebody() -> dict:
    """trot.batched_solve (dense physics, frozen linearizer) and
    trot.solve_batch_lanes (through the substep kernel; frozen and FD
    Jacobians) at bench.py's whole-body shape: the dense solve held to JAX's
    batched_solve on the CPU, the lanes solves' warm start to the plain
    substep's and their FD Jacobians to the plain substep's in float64; the
    lanes solves' final costs against the plain substep's, JAX's and a
    nudged start's recorded."""
    out = {}
    # 1. the dense solver: no kernel on its path
    cfg, mc, params, probs = wb_setup("frozen")
    pb = params.expand(WB_BATCH)   # per-problem robots, as bench.py's broadcast params
    warm = trot.batched_solve(cfg, dataclasses.replace(mc, n_iter=0), pb, probs)
    res, r = _wb_measure("dense", lambda: trot.batched_solve(cfg, mc, pb, probs), 0)
    r["warm_cost"], r["cost"] = _wb_distinct(warm.cost), _wb_distinct(res.cost)
    r["trace"] = res.cost_trace[:WB_DISTINCT].tolist()
    _wb_compare("dense", r, JAX_WB_WARM_COST, JAX_WB_COST, "JAX batched_solve", gate=True)
    _wb_log("dense batched_solve, frozen", r, wb_flops("frozen", False))
    out["dense_frozen"] = r

    # 2. the lanes solver, frozen: launches = (1 + n_iter) T model_substeps
    frozen_launches = (1 + mc.n_iter) * mc.horizon * mc.model_substeps
    warm_m = dataclasses.replace(mc, n_iter=0)
    warm = trot.solve_batch_lanes(cfg, warm_m, params, probs)
    lanes_frozen = lambda p: trot.solve_batch_lanes(cfg, mc, params, p)  # noqa: E731
    res_k, r = _wb_measure("lanes frozen", lambda: lanes_frozen(probs), frozen_launches)
    r["warm_cost"], r["cost"] = _wb_distinct(warm.cost), _wb_distinct(res_k.cost)
    with _GraphedPlainSubstep():
        warm_p = trot.solve_batch_lanes(cfg, warm_m, params, probs)
        res_p = lanes_frozen(probs)
    r["plain_warm_cost"], r["plain_cost"] = _wb_distinct(warm_p.cost), _wb_distinct(res_p.cost)
    r["trace"] = res_k.cost_trace[:WB_DISTINCT].tolist()
    r["plain_trace"] = res_p.cost_trace[:WB_DISTINCT].tolist()
    _wb_compare("lanes frozen", r, r["plain_warm_cost"], r["plain_cost"], "the plain substep",
                gate=False)
    _wb_compare("lanes frozen", r, None, JAX_WB_COST, "JAX batched_solve", gate=False)
    _wb_nudge("lanes frozen", r, lanes_frozen, probs)
    _wb_log("solve_batch_lanes, frozen", r, wb_flops("frozen", True))
    out["lanes_frozen"] = r

    # 3. the lanes solver, FD: + n_iter (T / linearize_chunk) model_substeps launches
    cfg, mc_fd, params, probs = wb_setup("fd")
    fd_launches = frozen_launches + mc_fd.n_iter * (mc_fd.horizon // mc_fd.linearize_chunk) \
        * mc_fd.model_substeps
    lanes_fd = lambda p: trot.solve_batch_lanes(cfg, mc_fd, params, p)  # noqa: E731
    res_fd, r = _wb_measure("lanes fd", lambda: lanes_fd(probs), fd_launches)
    r["cost"] = _wb_distinct(res_fd.cost)
    r["trace"] = res_fd.cost_trace[:WB_DISTINCT].tolist()
    r["over_frozen"] = [c / f for c, f in zip(r["cost"], out["lanes_frozen"]["cost"])]
    log(f"[13] lanes fd: final costs {[round(c, 3) for c in r['cost']]}, "
        f"{[round(x, 4) for x in r['over_frozen']]} x the frozen run's")
    if not bool((res_fd.cost < warm.cost).all()):
        raise RuntimeError("phase 13 lanes fd: a final cost is not below its warm start")
    _wb_nudge("lanes fd", r, lanes_fd, probs)
    r["jacobians"] = _check_fd_jacobians(cfg, mc_fd, params, {
        "warm start": (warm.xs, warm.us), "FD solve's result": (res_fd.xs, res_fd.us)})
    _wb_log("solve_batch_lanes, fd", r, wb_flops("fd", True))
    out["lanes_fd"] = r
    out["launch_formula"] = {"frozen": "(1 + n_iter) * horizon * model_substeps",
                             "fd": "(1 + n_iter) * horizon * model_substeps + n_iter * "
                                   "(horizon / linearize_chunk) * model_substeps",
                             "frozen_launches": frozen_launches, "fd_launches": fd_launches}
    out["launches"] = {"phys_substep": out["lanes_frozen"]["launches"]["phys_substep"]
                       + out["lanes_fd"]["launches"]["phys_substep"],
                       "lstm_cell": 0, "lstm_seq_train": 0, "lstm_seq_bwd": 0,
                       "lstm_cell_rows": 0}
    return out


def _wb_compare(name: str, r: dict, warm_ref, cost_ref, what: str, gate: bool) -> None:
    """The distinct problems' warm-start costs against ``what``'s, held within
    WB_WARM_RTOL; their final costs against it, held within WB_COST_RTOL if
    ``gate``, else recorded."""
    for key, got, want in (("warm", r.get("warm_cost"), warm_ref),
                           ("final", r["cost"], cost_ref)):
        if want is None:
            continue
        rtol = WB_WARM_RTOL if key == "warm" else WB_COST_RTOL if gate else None
        rel = [abs(g / w - 1) for g, w in zip(got, want)]
        r[f"{key}_rel_vs_{'jax' if 'JAX' in what else 'plain'}"] = rel
        log(f"[13] {name}: {key} costs {[round(g, 3) for g in got]}, "
            f"{[round(x, 5) for x in rel]} off {what}'s "
            f"({'recorded' if rtol is None else f'limit {rtol:g}'})")
        if rtol is not None and max(rel) > rtol:
            raise RuntimeError(f"phase 13 {name}: {key} costs {got} vs {what} {want}")


# --- phase 14 -----------------------------------------------------------------

WB_LOOP_SITES = {**WB_SITES, "env_step": (bp, "step_batch")}


def _wb_steady(cfg, mc, cmds, n: int = 4) -> dict:
    """Control steps 2..n of one fleet rollout, past the first, which
    captures the linearizer's CUDA graph: wall ms a step, device ms a step
    under torch.profiler, and ms a step by WB_LOOP_SITES with the device
    synchronized around each of their calls."""
    segments = mpc_runtime._wb_segments(cfg, mc, cmds, torch.Generator(device=DEVICE), n, 1,
                                        0.0, False, DEVICE, None)
    with _SyncedTimers(WB_LOOP_SITES) as acc:
        next(segments)
        torch.cuda.synchronize()
        before = dict(acc)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in segments:
                pass
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    k = n - 1
    ms, dev = wall / k * 1e3, _kernel_device_ms(prof)["all"] / k
    split = {s: (acc[s] - before[s]) / k * 1e3 for s in WB_LOOP_SITES}
    split["rest"] = ms - sum(split.values())
    return {"ms": ms, "device_ms": dev, "device_busy": dev / ms if dev > 0 else None,
            "ms_by_site": split}


def _loop_sites(d: dict) -> dict:
    """A control step of the loop by WB_LOOP_SITES, summed into: the dense
    model steps (the rollout and the line search), the linearizer's replays,
    Riccati, the cost derivatives, the env step and the rest (the step-size
    pick among it); with the total where ``d`` has one."""
    out = {"dense_model_steps": d["rollout"] + d["line_search"],
           "linearizer_replay": d["linearize"], "riccati": d["riccati"],
           "cost_derivatives": d["cost_derivatives"] + d["terminal_derivatives"],
           "env_step": d["env_step"]}
    out["rest"] = d.get("total", sum(d.values())) - sum(out.values())
    if "total" in d:
        out["total"] = d["total"]
    return out


def physics_only_counts(steps: int) -> dict:
    """What an MPC loop of ``steps`` control steps launches: the physics
    kernel once a step, no LSTM kernel."""
    return {"phys_substep": PHYS_LAUNCHES_PER_STEP * steps, "lstm_cell": 0, "lstm_seq_train": 0,
            "lstm_seq_bwd": 0}


def phase_wb_fleet() -> dict:
    """(a) wb_mpc_rollout_batch at bench.py's fleet configuration: row 1 of a
    2-command batch against its command alone, then the measured run with its
    launches, falls, rate, peak memory and bound, then ops and ms a control
    step by site and the device busy share in steady state."""
    cfg = config.test_default().replace(terrain=False, crucial=False)
    mc = trot.MPCConfig(**WB_FLEET_MC)
    i = np.arange(WB_FLEET_B)
    cmds = np.stack([0.5 + 2.5 * (i % 8) / 7.0, 0.0 * i, 0.0 * i], -1).astype(np.float32)
    fleet = lambda c, n: mpc_runtime.wb_mpc_rollout_batch(  # noqa: E731
        cfg, mc, c, torch.Generator(device=DEVICE), n, device=DEVICE)
    pair, one = fleet(cmds[:2], WB_FLEET_CHECK_STEPS), fleet(cmds[1:2], WB_FLEET_CHECK_STEPS)
    batch_err = float((pair.gc[1] - one.gc[0]).abs().max())
    log(f"[14a] row 1 of a 2-command batch against cmd {cmds[1, 0]:.4f} alone over "
        f"{WB_FLEET_CHECK_STEPS} steps: gc within {batch_err:.3g} (limit {WB_FLEET_ATOL:g}); "
        f"solve costs within {float((pair.solve_cost[1] - one.solve_cost[0]).abs().max()):.3g}")
    if not batch_err <= WB_FLEET_ATOL:
        raise RuntimeError(f"phase 14a: a batch row differs from its command alone by {batch_err}")

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    logr = fleet(cmds, WB_FLEET_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    counts = read_counts()
    check_counts(counts, physics_only_counts(WB_FLEET_STEPS), "14a")
    for f in ("gc", "gv", "action", "solve_cost"):
        if not torch.isfinite(getattr(logr, f)).all():
            raise RuntimeError(f"phase 14a: non-finite {f}")
    falls = int(logr.done.sum())
    ms = wall / WB_FLEET_STEPS * 1e3
    ops = _loop_sites(ops_per_step_by_site(lambda n: fleet(cmds, n), WB_LOOP_SITES))
    steady = _wb_steady(cfg, mc, cmds)
    steady["ms_by_site"] = _loop_sites(steady["ms_by_site"])
    flops = (wb_flops("frozen", False, WB_FLEET_B, mc.horizon, mc.n_iter, mc.n_alphas,
                      relin_every=mc.relin_every)
             + WB_FLEET_B * phys_ops_per_env(8, pd_law=True))
    # a control step reads and writes each robot's state and plan, and reads its command
    nbytes = 4 * WB_FLEET_B * (2 * (37 + mc.horizon * 12) + 3)
    b_ms, b_by = bound_ms(nbytes, flops)
    busy = steady["device_busy"]
    log(f"[14a] fleet of {WB_FLEET_B} x {WB_FLEET_STEPS} control steps in {wall:.1f} s: {ms:.1f} "
        f"ms a control step, {WB_FLEET_B * WB_FLEET_STEPS / wall:.1f} controller-steps/s; falls "
        f"{falls}; peak memory {peak / 2 ** 20:.1f} MiB; bound {b_ms:.4f} ms a step ({b_by}: "
        f"{flops / 1e9:.3f} GFLOP)")
    log(f"[14a] steady state: {steady['ms']:.1f} ms a step, device busy "
        f"{'not measured' if busy is None else f'{busy:.4f}'} ({steady['device_ms']:.2f} ms); "
        "ms by site " + ", ".join(f"{k} {v:.1f}" for k, v in steady["ms_by_site"].items())
        + "; PyTorch ops by site " + ", ".join(f"{k} {v}" for k, v in ops.items()))
    return {"wall_s": wall, "ms_per_step": ms,
            "controller_steps_per_s": WB_FLEET_B * WB_FLEET_STEPS / wall, "falls": falls,
            "peak_memory_bytes": peak, "launches": counts, "batch_vs_single_gc": batch_err,
            "torch_ops_per_step": ops, "steady": steady, "bound_ms": b_ms, "bound_by": b_by,
            "flops_per_step": flops}


def _first_above(err: np.ndarray, limit: float):
    hit = np.nonzero(err > limit)[0]
    return int(hit[0]) if len(hit) else None


def phase_wb_track() -> dict:
    """(b) cli.mpc --engine wb at cmd 1-5 for WB_TRACK_STEPS steps per
    schedule batch, held to the JAX lanes and per-env loops."""
    cmds = [float(c) for c in WB_TRACK_COMMANDS.split(",")]
    batches = list(cli_mpc.schedule_batches(config.test_default(), cmds, "wb").values())
    argv = ["--engine", "wb", "--commands", WB_TRACK_COMMANDS, "--steps", str(WB_TRACK_STEPS),
            "--device", DEVICE]
    logs, saved = [], mpc_runtime.wb_mpc_rollout

    def kept(*a, **kw):
        logs.append(saved(*a, **kw))
        return logs[-1]
    reset_counts()
    mpc_runtime.wb_mpc_rollout = kept
    try:
        t0 = time.perf_counter()
        res = cli_mpc.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mpc_runtime.wb_mpc_rollout = saved
    counts = read_counts()
    check_counts(counts, physics_only_counts(WB_TRACK_STEPS * len(batches)), "14b")
    gc = {vx: lg.gc[:, b].cpu().numpy() for vxs, lg in zip(batches, logs)
          for b, vx in enumerate(vxs)}
    failed, rows = [], []
    for r in res["rows"]:
        vx, want = r["command"], JAX_WB_TABLE[r["command"]]
        jb = np.asarray(JAX_WB_BASES[vx])[:len(gc[vx])]
        d = np.abs(gc[vx][:len(jb), :3] - jb).max(axis=1)
        base_err = float(d[:WB_BASE_ROWS].max())
        v_tol = max(WB_V_TOL, 2 * want["nudge_spread"])
        row = {**r, "base_err": base_err, "bases_first_above_1e-3": _first_above(d, 1e-3),
               "v_tol": v_tol, "jax": want}
        rows.append(row)
        log(f"[14b] cmd {vx:.0f}: v {r['v_mean']:.4f} (JAX lanes {want['v_lanes']:.4f}, diff "
            f"{r['v_mean'] - want['v_lanes']:+.4f}; JAX per-env {want['v_per_env']:.4f}, diff "
            f"{r['v_mean'] - want['v_per_env']:+.4f}; JAX's nudge spread "
            f"{want['nudge_spread']:.4f}, limit {v_tol:.4f}), falls {r['falls']} "
            f"(JAX lanes {want['falls_lanes']}, per-env {want['falls_per_env']}); bases over "
            f"{WB_BASE_ROWS} steps within {base_err:.3g} of JAX lanes (limit {WB_BASE_ATOL:g}), "
            f"first above 1e-3 at step {row['bases_first_above_1e-3']} of {len(jb)}; solve cost "
            f"~{r['solve_cost']:.2f} (JAX lanes mean {want['cost_lanes']:.2f}); "
            f"T={r['period']:.2f}")
        if (not base_err <= WB_BASE_ATOL or r["falls"] != want["falls_lanes"]
                or not abs(r["v_mean"] - want["v_lanes"]) <= v_tol
                or not abs(r["v_mean"] - want["v_per_env"]) <= v_tol):
            failed.append(vx)
    n = WB_TRACK_STEPS * len(batches)
    log(f"[14b] {WB_TRACK_STEPS} control steps x {len(batches)} schedule batches in {wall:.1f} s: "
        f"{wall / n * 1e3:.1f} ms a control step of a batch")
    if failed:
        raise RuntimeError(f"phase 14b: commands {failed} miss the JAX loops (see the log)")
    return {"rows": rows, "wall_s": wall, "ms_per_step": wall / n * 1e3, "groups": len(batches),
            "launches": counts}


def phase_wb_parity(params) -> dict:
    """(c) mpc_vs_bp5 at cmd 1: the solve from JAX's start (its warm start held
    to JAX's, its final cost recorded), then the function end to end against
    JAX's mae and torque_mae."""
    cfg = ev._fixed_command_cfg(config.test_default())
    mc = trot.MPCConfig(horizon=50)
    x0 = torch.tensor([JAX_MPC_VS_BP5_X0], dtype=torch.float32, device=DEVICE)
    prob = trot.make_problem(cfg, x0[:, :19], x0[:, 19:],
                             torch.tensor([[1.0, 0.0, 0.0]], device=DEVICE),
                             torch.tensor([200 * cfg.control_dt], device=DEVICE), mc.horizon)
    params_n = mdl.nominal_params(cfg, DEVICE)
    warm = float(trot.solve(cfg, dataclasses.replace(mc, n_iter=0), params_n, prob).cost[0])
    t0 = time.perf_counter()
    sol = trot.solve(cfg, mc, params_n, prob)
    solve_s = time.perf_counter() - t0
    trace = sol.cost_trace[0].double().tolist()
    cost = trace[-1]
    warm_rel = abs(warm / JAX_MPC_VS_BP5["warm_cost"] - 1)
    cost_rel = abs(cost / JAX_MPC_VS_BP5["cost"] - 1)
    log(f"[14c] the solve from JAX's start ({solve_s:.1f} s): warm start {warm:.4f} (JAX "
        f"{JAX_MPC_VS_BP5['warm_cost']:.4f}, {warm_rel:.3g} off; limit {WB_WARM_RTOL:g}); final "
        f"cost {cost:.4f} (JAX {JAX_MPC_VS_BP5['cost']:.4f}, {cost_rel:.3g} off, recorded: a "
        f"1e-6 m nudge moves JAX's by {JAX_MPC_VS_BP5_SPREAD['cost']:.3g}); trace "
        f"{[round(c, 3) for c in trace]}")
    failed = []
    if not warm_rel <= WB_WARM_RTOL:
        failed.append("the warm start from JAX's start")
    if not (all(b <= a * (1 + 1e-6) for a, b in zip([warm] + trace, trace))
            and np.isfinite(trace).all()):
        failed.append("the solve from JAX's start does not descend")
    reset_counts()
    t0 = time.perf_counter()
    res = parity.mpc_vs_bp5(config.test_default(), params, 1.0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, rollout_counts(200 + 50 + 1), "14c")
    got = {"mae": res.mae, "torque_mae": res.torque_mae}
    for k, v in got.items():
        want, tol = JAX_MPC_VS_BP5[k], max(MPC_VS_BP5_ATOL, 2 * JAX_MPC_VS_BP5_SPREAD[k])
        log(f"[14c] mpc_vs_bp5 cmd 1 ({wall:.1f} s): {k} {v:.5f} (JAX {want:.5f}, diff "
            f"{v - want:+.3g}; limit {tol:.3g})")
        if not abs(v - want) <= tol:
            failed.append(k)
    if failed:
        raise RuntimeError(f"phase 14c: {failed}")
    return {**got, "warm_from_jax": warm, "warm_from_jax_rel": warm_rel,
            "solve_from_jax_cost": cost, "solve_from_jax_rel": cost_rel,
            "solve_from_jax_trace": trace, "solve_from_jax_s": solve_s, "wall_s": wall,
            "launches": counts}


def phase_wb_terrain() -> dict:
    """(d) the terrain-model loop: finite, upright, one physics launch a step;
    bases against the JAX lanes loop's recorded."""
    env, mc = mpc_runtime.wb_speed_schedule(config.test_default(), 1.0)
    env = env.replace(terrain=True, terrain_z_scale=WB_TERRAIN_Z)
    reset_counts()
    t0 = time.perf_counter()
    logr = mpc_runtime.wb_mpc_rollout(env, mc, np.array([1.0, 0.0, 0.0], np.float32),
                                      torch.Generator(device=DEVICE), WB_TERRAIN_STEPS,
                                      terrain_model=True, device=DEVICE,
                                      terrain_offset=np.array([JAX_WB_TERRAIN["offset"]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, physics_only_counts(WB_TERRAIN_STEPS), "14d")
    gc = logr.gc.cpu().numpy()
    d = np.abs(gc[:, :3] - np.asarray(JAX_WB_TERRAIN["bases"])[:WB_TERRAIN_STEPS]).max(axis=1)
    upright = bool(np.isfinite(gc).all() and torch.isfinite(logr.solve_cost).all()
                   and (gc[:, 2] > 0.2).all() and (gc[:, 2] < 0.5).all()
                   and not logr.done.any())
    log(f"[14d] terrain model, {WB_TERRAIN_STEPS} steps in {wall:.1f} s: finite and upright "
        f"{upright}; bases against the JAX lanes loop's: first step {d[0]:.3g}, all "
        f"{d.max():.3g}; first above 1e-3 at step {_first_above(d, 1e-3)}")
    if not upright:
        raise RuntimeError("phase 14d: the terrain-model loop is not finite and upright")
    return {"first_step_base_err": float(d[0]), "base_err": d.tolist(), "wall_s": wall,
            "launches": counts}


# --- phase 15 -----------------------------------------------------------------

def _no_physics_counts(lstm_pairs: int, sequences: int = 0) -> dict:
    """What a path on the per-env step launches: no physics kernel, ``lstm_pairs``
    inference launches, and one sequence-forward and one sequence-backward
    launch a layer for each of ``sequences`` BPTT sequences."""
    return {"phys_substep": 0, "lstm_cell": lstm_pairs, "lstm_seq_train": LSTM_LAYERS * sequences,
            "lstm_seq_bwd": LSTM_LAYERS * sequences}


def phase_perenv_eval(variant: str) -> dict:
    """(a) hard contact, (b) the meteorite attacks: the flagship at cmd 1-5 as
    one batch on the per-env step, held to JAX's analysis.eval."""
    tag = {"hard": "15a", "crucial": "15b"}[variant]
    cfg = config.test_default().replace(terrain=False, crucial=variant == "crucial",
                                        hard_contact=variant == "hard")
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    cmds = np.array([[c, 0.0, 0.0] for c in PERENV_COMMANDS], np.float32)
    reset_counts()
    t0 = time.perf_counter()
    logr = ev.policy_rollout(ev._fixed_command_cfg(cfg), params, cmds,
                             torch.Generator(device=DEVICE), PERENV_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, _no_physics_counts(LSTM_LAUNCHES_PER_STEP * PERENV_STEPS), tag)
    gc = logr.gc.cpu().numpy()
    failed, rows = [], []
    for b, r in enumerate(ev.tracking_rows(cfg, logr, PERENV_COMMANDS)):
        want = JAX_PERENV[variant][r["command"]]
        base_err = float(np.abs(gc[:PERENV_BASE_ROWS, b, :3] - np.asarray(want["bases"])).max())
        v_tol = max(PERENV_V_TOL, 2 * want["nudge_spread"])
        rows.append({**r, "base_err": base_err, "v_tol": v_tol, "jax": want})
        log(f"[{tag}] cmd {r['command']:.0f}: v {r['v_mean']:.4f} (JAX {want['v']:.4f}, diff "
            f"{r['v_mean'] - want['v']:+.4f}; JAX's nudge spread {want['nudge_spread']:.4f}, "
            f"limit {v_tol:.4f}), falls {r['falls']} (JAX {want['falls']}); bases over "
            f"{PERENV_BASE_ROWS} steps within {base_err:.3g} of JAX (limit {PERENV_BASE_ATOL:g})")
        if (not base_err <= PERENV_BASE_ATOL or r["falls"] != want["falls"]
                or not abs(r["v_mean"] - want["v"]) <= v_tol):
            failed.append(r["command"])
    ms = wall / PERENV_STEPS * 1e3
    log(f"[{tag}] {PERENV_STEPS} control steps of {len(cmds)} envs in {wall:.1f} s: {ms:.1f} ms a "
        "control step")
    if failed:
        raise RuntimeError(f"phase {tag}: commands {failed} miss JAX's evaluation (see the log)")
    return {"rows": rows, "wall_s": wall, "ms_per_step": ms, "launches": counts}


def _config_txt(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "config.txt")) as f:
        return dict(line.rstrip("\n").split(": ", 1) for line in f if ": " in line)


def _trained_run(argv: list, updates: int, steps: int, tag: str) -> dict:
    """One cli.train run on the per-env path: its launches, finite metrics,
    the loss falling within each update, every leaf moved from the flagship."""
    reset_counts()
    t0 = time.perf_counter()
    run_dir = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, _no_physics_counts(LSTM_LAUNCHES_PER_STEP * updates * (steps + 1),
                                            updates * TRAIN_EPOCHS), tag)
    cfg_txt = _config_txt(run_dir)
    if cfg_txt["use_lanes_physics"] != "False":
        raise RuntimeError(f"phase {tag}: cli.train chose the lanes path")
    rows = metrics_io.read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    if len(rows) != updates:
        raise RuntimeError(f"phase {tag}: {len(rows)} metrics rows, expected {updates}")
    for i, r in enumerate(rows):
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad or not r["loss_last_epoch"] < r["loss_first_epoch"]:
            raise RuntimeError(f"phase {tag}, update {i + 1}: non-finite {bad}, or loss "
                               f"{r['loss_first_epoch']} -> {r['loss_last_epoch']}")
        log(f"[{tag}] update {i + 1}: {r['time_rollout_s']:.2f} s rollout + "
            f"{r['time_epochs_s']:.2f} s for {TRAIN_EPOCHS} epochs; loss "
            f"{r['loss_first_epoch']:.5f} -> {r['loss_last_epoch']:.5f}; reward/step "
            f"{r['reward_per_step']:.4f}; episodes ended {r['ep_count']:.0f}")
    start = mio.policy_params_to_numpy(mio.load_bp5_csv(ARTIFACT, device=DEVICE))
    trained = mio.policy_params_to_numpy(
        mio.load_checkpoint(os.path.join(run_dir, "ckpt_final.pkl"), DEVICE)[0])
    still = [k for k in trained if not np.abs(trained[k] - start[k]).max() > 0]
    if still:
        raise RuntimeError(f"phase {tag}: parameters that did not change: {still}")
    ms = float(np.mean([r["time_rollout_s"] for r in rows])) / steps * 1e3
    log(f"[{tag}] {updates} update(s) in {wall:.1f} s ({ms:.1f} ms a rollout step); every "
        f"parameter leaf changed; hard_contact {cfg_txt['hard_contact']}, crucial "
        f"{cfg_txt['crucial']}, use_lanes_physics {cfg_txt['use_lanes_physics']}")
    return {"run_dir": os.path.relpath(run_dir, ROOT), "wall_s": wall, "updates": rows,
            "rollout_ms_per_step": ms, "launches": counts}


def phase_perenv_training() -> tuple[dict, dict]:
    """(c) cli.train at the YAML's 200 envs on the per-env path, then one
    update with hard contact and the attacks."""
    import yaml
    if config.from_yaml(TRAIN_CFG).num_envs != PERENV_B or cli_train.use_lanes(PERENV_B, False,
                                                                                 False):
        raise RuntimeError("configs/bp5_train.yaml no longer trains on the per-env path")
    base = ["--load", ARTIFACT, "--lr", "5e-4", "--log-dir", PERENV_LOG_DIR, "--device", DEVICE]
    flat = _trained_run(["--cfg", TRAIN_CFG, "--max-updates", str(PERENV_TRAIN_UPDATES),
                         "--n-steps", str(PERENV_TRAIN_STEPS)] + base,
                        PERENV_TRAIN_UPDATES, PERENV_TRAIN_STEPS, "15c")
    with open(TRAIN_CFG) as f:
        doc = yaml.safe_load(f)
    doc["environment"].update({"HardContact": True, "Crutial": True})
    variant_cfg = os.path.join(ROOT, "build", "bp5_train_hard_crucial.yaml")
    os.makedirs(os.path.dirname(variant_cfg), exist_ok=True)
    with open(variant_cfg, "w") as f:
        yaml.safe_dump(doc, f)
    variants = _trained_run(["--cfg", variant_cfg, "--max-updates", "1",
                             "--n-steps", str(PERENV_VARIANT_STEPS)] + base,
                            1, PERENV_VARIANT_STEPS, "15c")
    if not {k: _config_txt(os.path.join(ROOT, variants["run_dir"]))[k]
            for k in ("hard_contact", "crucial")} == {"hard_contact": "True", "crucial": "True"}:
        raise RuntimeError("phase 15c: the variant run lost HardContact or Crutial")
    return flat, variants


def _ppo3_run(agent, env, steps: int) -> dict:
    obs = env.observe()
    for _ in range(steps):
        obs, reward, done, _ = env.step(agent.get_next_action(obs))
        agent.collect(obs, reward, done)
    return agent.learn(obs)


def phase_ppo3() -> tuple[dict, dict]:
    """(d) PPO3 over NumpyVecEnv with the flagship's LSTM; then MlpPolicy
    through PPO3 and through ppo.learn."""
    cfg = config.from_yaml(TRAIN_CFG)
    env = vec.NumpyVecEnv(cfg, seed=cfg.seed, device=DEVICE)
    agent = ppo3.PPO3(ppo.PPOConfig(learning_rate=5e-4), n_envs=cfg.num_envs, device=DEVICE)
    agent.params = mio.load_bp5_csv(ARTIFACT, device=DEVICE).requires_grad_()
    agent.optimizer = ppo.make_optimizer(agent.cfg, agent.params)
    start = mio.policy_params_to_numpy(agent.params)
    reset_counts()
    t0 = time.perf_counter()
    m = _ppo3_run(agent, env, PPO3_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, _no_physics_counts(LSTM_LAUNCHES_PER_STEP * (PPO3_STEPS + 1),
                                            TRAIN_EPOCHS), "15d")
    moved = mio.policy_params_to_numpy(agent.params)
    if not (all(np.isfinite(v) for v in m.values())
            and all(np.abs(moved[k] - start[k]).max() > 0 for k in start)):
        raise RuntimeError(f"phase 15d: PPO3 metrics {m}, or a leaf that did not change")
    log(f"[15d] PPO3 (LSTM) {PPO3_STEPS} steps x {cfg.num_envs} envs and learn in {wall:.1f} s: "
        + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    lstm_rec = {"metrics": m, "wall_s": wall, "launches": counts}

    mlp_cfg = ppo.PPOConfig(policy="MlpPolicy", learning_rate=5e-4, n_steps=PPO3_STEPS)
    agent = ppo3.PPO3(mlp_cfg, n_envs=cfg.num_envs, device=DEVICE)
    start = mio.mlp_params_to_numpy(agent.params)
    env.reset()
    rows = []
    reset_counts()
    t0 = time.perf_counter()
    m = _ppo3_run(agent, env, PPO3_STEPS)
    ts = ppo.learn(cfg, mlp_cfg, cfg.num_envs * PPO3_STEPS, cfg.seed, verbose=False,
                   metrics_hook=rows.append, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, _no_physics_counts(0), "15d")
    moved = mio.mlp_params_to_numpy(agent.params)
    if not (len(rows) == 1 and all(np.isfinite(v) for v in {**m, **rows[0]}.values())
            and all(np.abs(moved[k] - start[k]).max() > 0 for k in start)
            and isinstance(ts.params, type(agent.params))):
        raise RuntimeError(f"phase 15d: MlpPolicy metrics {m} / {rows}, or a leaf that did not "
                           "change")
    log(f"[15d] MlpPolicy: PPO3 and one ppo.learn update in {wall:.1f} s; PPO3 loss "
        f"{m['loss']:.4g}, ppo.learn loss {rows[0]['loss_first_epoch']:.4g} -> "
        f"{rows[0]['loss_last_epoch']:.4g}")
    return lstm_rec, {"ppo3_metrics": m, "learn_metrics": rows[0], "wall_s": wall,
                      "launches": counts}


def _perenv_sites(fn, hard: bool) -> dict:
    if fn is bp.step_batch:
        return {"pre": (bp, "_pre_substeps"), "physics_call": (phys_cuda, "control_step"),
                "post": (bp, "_post_graphs")}
    dense = ({"substep_hard": (dyn, "substep_hard"), "pgs": (hard_contact, "solve_impulses")}
             if hard else {"forward_dynamics": (dyn, "forward_dynamics"),
                           "integrate": (dyn, "integrate")})
    return {"pre": (bp, "_pre_substeps"), **dense, "post": (bp, "_post_substeps")}


def _perenv_split(d: dict) -> dict:
    """A control step by site: pre, the substeps (dense dynamics, the PGS solve
    inside them, or step_batch's physics call), post and the rest."""
    out = {"pre": d["pre"], "post": d["post"]}
    if "physics_call" in d:
        out["physics_call"] = d["physics_call"]
    elif "pgs" in d:
        out["dense_substeps"], out["pgs"] = d["substep_hard"] - d["pgs"], d["pgs"]
    else:
        out["dense_substeps"] = d["forward_dynamics"] + d["integrate"]
    out["rest"] = d.get("total", sum(d.values())) - sum(out.values())
    if "total" in d:
        out["total"] = d["total"]
    return out


def phase_perenv_timing() -> dict:
    """(e) step (compliant and hard) against step_batch on the training
    config at 200 and 1024 envs: ms a control step, PyTorch ops and ms a step
    by site, the device's busy share, peak memory. Recorded, not held."""
    cfg = config.from_yaml(TRAIN_CFG)
    out = {}
    for B in (PERENV_B, FULL_B):
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state = bp.env_init(cfg.replace(num_envs=B), B, gen, DEVICE)
        act = torch.zeros((B, bp.ACT_DIM), device=DEVICE)
        for name, fn, c in (("step", bp.step, cfg), ("step_hard", bp.step,
                                                     cfg.replace(hard_contact=True)),
                            ("step_batch", bp.step_batch, cfg)):
            if name == "step_hard" and B != PERENV_B:
                continue        # recorded at the training width only
            c = c.replace(num_envs=B)

            def run(n, st=state):
                for _ in range(n):
                    st = fn(c, st, act, gen).state
                return st
            run(1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            run(PERENV_TIMING_STEPS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PERENV_TIMING_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated() - before
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(PERENV_TIMING_STEPS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev = _kernel_device_ms(prof)["all"]
            sites = _perenv_sites(fn, name == "step_hard")
            ops = _perenv_split(ops_per_step_by_site(run, sites))
            split = {}
            if B == PERENV_B:
                with _SyncedTimers(sites) as acc:
                    t0 = time.perf_counter()
                    run(2)
                    synced = (time.perf_counter() - t0) / 2 * 1e3
                split = _perenv_split({k: v / 2 * 1e3 for k, v in acc.items()} | {"total": synced})
            rec = {"ms": ms, "device_busy": dev / (wall * 1e3) if dev > 0 else None,
                   "device_ms": dev / PERENV_TIMING_STEPS, "peak_memory_bytes": peak,
                   "torch_ops_per_step": ops, "synced_ms_by_site": split}
            out[f"{name}_{B}"] = rec
            busy = "not measured" if dev <= 0 else f"{dev / (wall * 1e3):.4f}"
            log(f"[15e] {name} at {B} envs: {ms:.1f} ms a control step, device busy {busy}, "
                f"peak {peak / 2 ** 20:.1f} MiB; PyTorch ops by site "
                + ", ".join(f"{k} {v}" for k, v in ops.items()) + "; ms by site (synced) "
                + (", ".join(f"{k} {v:.1f}" for k, v in split.items()) or "not measured"))
    return out


# --- phase 16 -----------------------------------------------------------------

class plain_rows:
    """Inside, models.lstm.forward runs per-row weights through the plain
    twin of the per-row kernel."""

    def __enter__(self):
        self.saved = lstm_cuda.lstm_cell_pair_rows
        lstm_cuda.lstm_cell_pair_rows = lstm.lstm_cell_pair_rows

    def __exit__(self, *exc):
        lstm_cuda.lstm_cell_pair_rows = self.saved


def _rows_twin(cfg, stacked, cmd, steps: int) -> dict:
    """The landscape's closed loop for ``steps`` steps on the kernel, with the
    plain twin computing each step's action and LSTM state from the same
    inputs: the largest differences."""
    B = stacked.pi_b.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cmd = torch.tensor(cmd, device=DEVICE).expand(B, 3)
    state = bp.env_init(cfg, B, gen, DEVICE).replace(command=cmd, command_filtered=cmd)
    obs = bp.observe(cfg, state)
    h = torch.zeros((B, lstm.state_size([w.wh.shape[-2] for w in stacked.pi_lstm])),
                    device=DEVICE)
    no_reset = torch.zeros(B, device=DEVICE)
    cmd_n = (cmd - bp.obs_mean(cfg, DEVICE)[:3]) / bp.obs_std(cfg, DEVICE)[:3]
    err_a = err_s = 0.0
    for _ in range(steps):
        o = torch.cat([cmd_n, obs[:, 3:]], dim=-1)
        a, h_new = lstm.deterministic_action(stacked, o, h, no_reset)
        with plain_rows():
            a_p, h_p = lstm.deterministic_action(stacked, o, h, no_reset)
        err_a = max(err_a, float((a - a_p).abs().max()))
        err_s = max(err_s, float((h_new - h_p).abs().max()))
        out = bp.step_batch(cfg, state.replace(command=cmd, command_filtered=cmd), a, gen)
        state, obs, h = out.state, out.obs, h_new
    return {"action": err_a, "lstm_state": err_s}


def phase_landscape() -> dict:
    """(a) the reward landscape at 5151 blends as one batch through the per-row
    kernel and the physics kernel, held to JAX on its 15-blend coarse grid."""
    cfg = config.test_default()
    anchors = [mio.load_bp5_csv(a, device=DEVICE) for a in LANDSCAPE_ANCHORS]
    w = landscape.simplex_grid(LANDSCAPE_STEP)
    cmd = [LANDSCAPE_VX, 0.0, 0.0]
    stacked = landscape.blend_params(anchors, w)
    twin = _rows_twin(ev._fixed_command_cfg(cfg), stacked, cmd, LANDSCAPE_TWIN_STEPS)
    log(f"[16a] per-row kernel against its plain twin over {LANDSCAPE_TWIN_STEPS} steps of "
        f"{len(w)} blends: max |err| action {twin['action']:.3g}, LSTM state "
        f"{twin['lstm_state']:.3g} (limit {LANDSCAPE_TWIN_ATOL:g})")
    if not max(twin.values()) <= LANDSCAPE_TWIN_ATOL:
        raise RuntimeError(f"phase 16a: the per-row kernel parts from its plain twin: {twin}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        landscape._landscape_batch(cfg, stacked, cmd, gen, LANDSCAPE_PROF_STEPS, DEVICE)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    rows_ms = sum(ms for name, ms in device_events(prof) if "lstm_cell_pair_rows_kernel" in name)
    dev = _kernel_device_ms(prof)
    del stacked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    res = landscape.reward_landscape(cfg, *anchors, command=cmd, step=LANDSCAPE_STEP,
                                     n_steps=LANDSCAPE_STEPS, gen=gen, chunk=len(w),
                                     device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - before
    check_counts(counts, {"phys_substep": LANDSCAPE_STEPS,
                          "lstm_cell_rows": LSTM_LAUNCHES_PER_STEP * LANDSCAPE_STEPS}, "16a")
    if not (np.isfinite(res["terms"]).all() and res["terms"].shape == (len(w), 8)):
        raise RuntimeError("phase 16a: non-finite or misshapen landscape terms")
    coarse = landscape.simplex_grid(LANDSCAPE_CHECK_STEP)
    idx = [int(np.flatnonzero((w == r).all(1))[0]) for r in coarse]
    want = np.asarray(JAX_LANDSCAPE["terms"])
    spread = np.asarray(JAX_LANDSCAPE["terms_nudge_spread"])
    got = res["terms"][idx].astype(np.float64)
    tol = np.maximum(LANDSCAPE_RTOL * np.abs(want), 2 * spread) + LANDSCAPE_ATOL
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-9)
    alive_ok = bool((res["alive_len"][idx] == np.asarray(JAX_LANDSCAPE["alive_len"])).all())
    ms = wall / LANDSCAPE_STEPS * 1e3
    busy = dev["all"] / prof_wall if dev["all"] > 0 else None
    rec = {"blends": len(w), "wall_s": wall, "ms_per_step": ms, "peak_memory_bytes": peak,
           "device_busy": busy, "rows_kernel_ms_per_step": rows_ms / LANDSCAPE_PROF_STEPS,
           "device_ms_per_step": dev["all"] / LANDSCAPE_PROF_STEPS, "twin_max_abs_err": twin,
           "coarse_terms": got.tolist(), "coarse_alive_len": res["alive_len"][idx].tolist(),
           "coarse_max_abs_err": float(np.abs(got - want).max()),
           "coarse_max_rel_err": float(rel[np.abs(want) > 1e-3].max()),
           "coarse_worst_over_tol": float((np.abs(got - want) / tol).max()),
           "alive_short": int((res["alive_len"] < LANDSCAPE_STEPS).sum()),
           "launches": counts}
    log(f"[16a] {len(w)} blends x {LANDSCAPE_STEPS} steps in {wall:.1f} s: {ms:.2f} ms a control "
        f"step; over {LANDSCAPE_PROF_STEPS} profiled steps the device busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'}, the per-row kernel "
        f"{rec['rows_kernel_ms_per_step']:.4f} ms a step (2 launches), all device time "
        f"{rec['device_ms_per_step']:.4f} ms; peak {peak / 2 ** 20:.1f} MiB; "
        f"{rec['alive_short']} blends fell")
    log(f"[16a] the {len(idx)} blends of step {LANDSCAPE_CHECK_STEP} against JAX: alive_len "
        f"{'equal' if alive_ok else 'DIFFERS'}, terms within {rec['coarse_max_abs_err']:.4g} "
        f"(relative {rec['coarse_max_rel_err']:.3g} where |JAX| > 1e-3; worst "
        f"{rec['coarse_worst_over_tol']:.3f} of its limit)")
    if not alive_ok or not (np.abs(got - want) <= tol).all():
        raise RuntimeError("phase 16a: the coarse grid misses JAX's landscape (see the log)")
    return rec


def _cli_run(argv: list, want: dict, tag: str):
    reset_counts()
    t0 = time.perf_counter()
    res = cli_test.main(argv + ["--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, want, tag)
    return res, wall, counts


def phase_entropy_kappa() -> dict:
    """(b) ``cli.test --kappa-entropy`` at cmd 1, 3, 5 with 4096 episodes each."""
    n_cmd = len(ENTROPY_COMMANDS.split(","))
    res, wall, counts = _cli_run(
        ["--model", ARTIFACT, "--kappa-entropy", "--commands", ENTROPY_COMMANDS, "--ensemble",
         str(ENTROPY_EPISODES), "--steps", str(ENTROPY_STEPS)],
        {"phys_substep": n_cmd * ENTROPY_STEPS,
         "lstm_cell": LSTM_LAUNCHES_PER_STEP * n_cmd * ENTROPY_STEPS}, "16b")
    rows = res["entropy_kappa"]
    for r in rows:
        log(f"[16b] cmd {r['command']:.0f}: entropy-kappa {r['kappa']:+.4f} +- "
            f"{r['kappa_err']:.4f} log_e/s, v {r['v_mean']:.4f}, survival {r['survival']:.4f}")
        if not (np.isfinite([r["kappa"], r["v_mean"]]).all() and 0.0 <= r["survival"] <= 1.0):
            raise RuntimeError(f"phase 16b: cmd {r['command']}: {r}")
    ms = wall / (n_cmd * ENTROPY_STEPS) * 1e3
    log(f"[16b] {n_cmd} x {ENTROPY_EPISODES} episodes x {ENTROPY_STEPS} steps in {wall:.1f} s: "
        f"{ms:.2f} ms a control step of {ENTROPY_EPISODES} envs")
    return {"rows": rows, "wall_s": wall, "ms_per_step": ms, "launches": counts}


def phase_kappa() -> dict:
    """(c) ``cli.test --kappa`` at cmd 1-5, kick 1 m/s: the five rows one
    batch of 1500 steps, held to JAX's recovery_sweep."""
    res, wall, counts = _cli_run(
        ["--model", ARTIFACT, "--kappa", "--commands", "1,2,3,4,5", "--kick", "1.0"],
        {"phys_substep": KAPPA_STEPS, "lstm_cell": LSTM_LAUNCHES_PER_STEP * KAPPA_STEPS}, "16c")
    failed = []
    for r in res["recovery"]:
        want = JAX_KAPPA[r["command"]]
        tol = max(KAPPA_TOL, 2 * want["nudge_spread"])
        r["jax"], r["tol"] = want, tol
        log(f"[16c] cmd {r['command']:.0f}: kappa {r['kappa']:+.4f} log_e/s (JAX "
            f"{want['kappa']:+.4f}, diff {r['kappa'] - want['kappa']:+.4f}, limit {tol:.3f}), "
            f"r2 {r['r2']:.3f}, {'survived' if r['survived'] else 'fell'} (JAX "
            f"{'survived' if want['survived'] else 'fell'})")
        if not abs(r["kappa"] - want["kappa"]) <= tol or r["survived"] != want["survived"]:
            failed.append(r["command"])
    ms = wall / KAPPA_STEPS * 1e3
    log(f"[16c] 5 envs x {KAPPA_STEPS} steps in {wall:.1f} s: {ms:.2f} ms a control step")
    if failed:
        raise RuntimeError(f"phase 16c: commands {failed} miss JAX's kappa (see the log)")
    return {"rows": res["recovery"], "wall_s": wall, "ms_per_step": ms, "launches": counts}


def _read_snapshot(port: int, out: dict, deadline: float) -> None:
    """A viewer: connect to the state server on ``port`` once it listens and
    read one published snapshot."""
    while time.perf_counter() < deadline:
        try:
            cli = native.StateClient(port)
        except OSError:
            time.sleep(0.01)
            continue
        try:
            while time.perf_counter() < deadline:
                if cli.meta() > 0:
                    out["meta"] = cli.meta()
                    out["seq"], out["snapshot"] = cli.state()
                    return
                time.sleep(0.001)
        finally:
            cli.close()


def phase_cli_modes() -> dict:
    """(d) one ``cli.test`` call with the single-rollout modes, the analysis
    of a rollout's log, and ``--teleop --serve`` read by a viewer."""
    import socket
    import threading

    os.makedirs(CLI_OUT_DIR, exist_ok=True)
    out = lambda name: os.path.join(CLI_OUT_DIR, name)  # noqa: E731
    delays = "0,1,2,5"
    n_rollouts = 4 + len(delays.split(",")) + 2   # torque, wc, ss, corr; delays; viewer; energy
    res, wall, counts = _cli_run(
        ["--model", ARTIFACT, "--vx", "2", "--steps", str(CLI_STEPS), "--torque", "--wc", "--ss",
         "--corr", "--delay", delays, "--save-energy-data", out("energy"), "--dump-info",
         out("info.csv"), "--viewer", out("viewer.html"), "--save-data", out("data")],
        {"phys_substep": n_rollouts * CLI_STEPS,
         "lstm_cell": LSTM_LAUNCHES_PER_STEP * n_rollouts * CLI_STEPS}, "16d")
    scalars = [res["torque_power"]["mean_power"], res["torque_power"]["tcot"],
               res["work_condition"]["violation_rate"], res["lstm_corr_mean_abs"],
               *res["state_space"]["q_range"], *(r["v_mean"] for r in res["latency"])]
    files = [out(f) for f in ("info.csv", "viewer.html", "data/results.json",
                              "energy/inverse_mass.npy", "data/state_space_q.npy")]
    minv = np.load(out("energy/inverse_mass.npy"))
    if not (np.isfinite(scalars).all() and all(os.path.getsize(f) > 0 for f in files)
            and minv.shape == (CLI_STEPS, 18, 18) and np.isfinite(minv).all()):
        raise RuntimeError(f"phase 16d: {res}")
    log(f"[16d] {n_rollouts} rollouts x {CLI_STEPS} steps in {wall:.1f} s "
        f"({wall / (n_rollouts * CLI_STEPS) * 1e3:.2f} ms a control step): mean power "
        f"{res['torque_power']['mean_power']:.1f} W, TCoT {res['torque_power']['tcot']:.3f}, "
        f"envelope violations {res['work_condition']['violation_rate']:.4f}, |corr| "
        f"{res['lstm_corr_mean_abs']:.3f}, v at latency " + ", ".join(
            f"{r['latency_ms']:.0f} ms {r['v_mean']:.3f}" for r in res["latency"]))
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    rollout_log = ev.policy_rollout(ev._fixed_command_cfg(config.test_default()), params,
                                    np.array([2.0, 0.0, 0.0]), torch.Generator(device=DEVICE),
                                    CLI_STEPS, device=DEVICE)
    pca = ev.value_pca(params, rollout_log)
    spec = ev.spectrogram(rollout_log.gv[:, 8].cpu().numpy(), config.test_default().control_dt)
    toes = ev.toe_trajectories(rollout_log)
    if not (np.isfinite(pca["coords"]).all() and np.isfinite(spec["db"]).all()
            and toes.shape == (CLI_STEPS, 4, 3) and np.isfinite(toes).all()):
        raise RuntimeError("phase 16d: non-finite value_pca, spectrogram or toe trajectories")
    log(f"[16d] value_pca: PC1+PC2 explain {pca['explained'].sum():.3f}; spectrogram "
        f"{spec['db'].shape}; toe z range {toes[..., 2].min():.3f}..{toes[..., 2].max():.3f} m")
    with socket.socket() as sock:   # a free port for the server
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    seen = {}
    viewer = threading.Thread(target=_read_snapshot,
                              args=(port, seen, time.perf_counter() + 120.0))
    viewer.start()
    try:
        tele, tele_wall, tele_counts = _cli_run(
            ["--model", ARTIFACT, "--teleop", "--serve", str(port), "--steps", str(TELEOP_STEPS)],
            {"phys_substep": TELEOP_STEPS, "lstm_cell": LSTM_LAUNCHES_PER_STEP * TELEOP_STEPS},
            "16d teleop")
    finally:
        viewer.join(timeout=130.0)
    if seen.get("meta") != 44 or not np.isfinite(seen["snapshot"]).all():
        raise RuntimeError(f"phase 16d: the viewer read {seen}")
    log(f"[16d] teleop {tele['teleop']['steps']} steps in {tele_wall:.1f} s "
        f"({tele_wall / TELEOP_STEPS * 1e3:.2f} ms a step, B = 1): mean v "
        f"{[round(v, 3) for v in tele['teleop']['v_mean']]}; a viewer read snapshot "
        f"{seen['seq']} of {seen['meta']} floats, base height {seen['snapshot'][2]:.3f} m")
    return {"results": res, "wall_s": wall, "launches": counts,
            "value_pca_explained": pca["explained"].tolist(),
            "teleop": {**tele["teleop"], "wall_s": tele_wall, "launches": tele_counts,
                       "snapshot_seq": seen["seq"], "snapshot_floats": seen["meta"]}}


# --- phase 17 -----------------------------------------------------------------

def phase_reftraj() -> dict:
    """(a) The flagship through step_batch with a synthesized RefTraj table at
    1024 envs: every env's references and phase observation on its table row
    at every step, one physics and two LSTM pair launches a step."""
    cfg = config.train_default().replace(manual_traj=False, num_envs=FULL_B)
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    t0 = time.perf_counter()
    table = reftraj.synthesize(cfg, np.array([[vx, 0.0, 0.0] for vx in (1, 2, 3, 4, 5)]),
                               REFTRAJ_FRAMES, device=DEVICE)
    table_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = bp.env_init(cfg, FULL_B, gen, DEVICE, ref_table=table)
    obs = bp.observe(cfg, state)
    h = torch.zeros((FULL_B, lstm.state_size([48, 48])), device=DEVICE)
    no_reset = torch.zeros(FULL_B, device=DEVICE)
    last = table.shape[0] - 1

    def off_rows(s: bp.EnvState) -> int:
        """Envs whose references or phase observation are not their row's."""
        row = table[(s.frame_idx.long() - 1).clamp(0, last)]
        ok = ((s.joint_ref == row[:, 0:12]).all(-1) & (s.joint_dot_ref == row[:, 12:24]).all(-1)
              & (s.command_filtered == row[:, 27:30]).all(-1)
              & (s.obs_double[:, 3:5] == row[:, 25:27]).all(-1))
        return int((~ok).sum())

    bad = [off_rows(state)]
    frames0 = state.frame_idx.clone()
    reset_counts()
    t1 = time.perf_counter()
    dones = 0
    for _ in range(REFTRAJ_STEPS):
        a, h = lstm.deterministic_action(params, obs, h, no_reset)
        out = bp.step_batch(cfg, state, a, gen, ref_table=table)
        state, obs = out.state, out.obs
        h = torch.where(out.done[:, None], torch.zeros_like(h), h)
        bad.append(off_rows(state))
        dones += int(out.done.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    check_counts(counts, rollout_counts(REFTRAJ_STEPS), "17a")
    if any(bad) or not torch.isfinite(state.gc).all():
        raise RuntimeError(f"17a: envs off their table rows by step: {bad}")
    log(f"[17a] table {tuple(table.shape)} built in {table_s:.2f} s; {FULL_B} envs x "
        f"{REFTRAJ_STEPS} steps on step_batch in {wall:.2f} s ({wall / REFTRAJ_STEPS * 1e3:.2f} "
        f"ms a step), start frames {int(frames0.min())}-{int(frames0.max())}, {dones} "
        f"episodes ended; every env on its table row at every step")
    return {"table_shape": list(table.shape), "table_s": table_s, "wall_s": wall,
            "ms_per_step": wall / REFTRAJ_STEPS * 1e3, "episodes_ended": dones,
            "launches": counts}


def _analytic_cfg():
    return config.from_yaml(TERRAIN_CFG).replace(terrain_sampled=False)


def _analytic_twin() -> dict:
    """The kernel's analytic instantiation against its plain twin over
    ANALYTIC_TWIN_STEPS control steps from the envs' spawn, each fed its own
    state; the twin's control step replayed from a CUDA graph."""
    cfg = ev._fixed_command_cfg(_analytic_cfg()).replace(crucial=False)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    s = bp.env_init(cfg, FULL_B, gen, DEVICE)
    P = lanes.params_to_lanes(s.params)
    pd = pd_torque.from_config(cfg)
    rows = lambda x: x.T.contiguous()  # noqa: E731
    pt, tnl, bw = rows(s.gc[:, 7:]), torch.zeros(12, FULL_B, device=DEVICE), \
        torch.zeros(6, FULL_B, device=DEVICE)
    terr = terrain.rows(s.terrain)
    tail = (cfg.substeps, cfg.contact_slip_vel, cfg.contact_impulse_mass / cfg.simulation_dt,
            cfg.simulation_dt)
    gc_k, gv_k = rows(s.gc), rows(s.gv)
    gc_p, gv_p = gc_k.clone(), gv_k.clone()

    def plain():
        return phys_cuda.control_step_plain(P, pd, gc_p, gv_p, pt, tnl, bw, *tail, terrain=terr)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_p = plain()
    errs, contact_from = [], None
    reset_counts()
    for step in range(ANALYTIC_TWIN_STEPS):
        out_k = phys_cuda.control_step(P, pd, gc_k, gv_k, pt, tnl, bw, *tail, terrain=terr)
        gc_k, gv_k = out_k[0].contiguous(), out_k[1].contiguous()
        graph.replay()
        gc_p.copy_(out_p[0])
        gv_p.copy_(out_p[1])
        errs.append(float((gc_k[:7] - gc_p[:7]).abs().max()))
        if contact_from is None and bool((out_k[5] > 0).any()):
            contact_from = step
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {"phys_substep": ANALYTIC_TWIN_STEPS,
                          "phys_analytic": ANALYTIC_TWIN_STEPS}, "17b twin")
    if not (max(errs) <= TERRAIN_BASE_ATOL and torch.isfinite(gc_k).all()
            and contact_from is not None):
        raise RuntimeError(f"17b: the analytic kernel parts from its plain twin: bases by step "
                           f"{errs}, first contact at step {contact_from}")
    log(f"[17b] analytic kernel vs its plain twin, {FULL_B} envs x {ANALYTIC_TWIN_STEPS} steps "
        f"(toes in contact from step {contact_from}): bases within {max(errs):.3g} (after 10 / "
        f"25 / 50 steps {errs[9]:.3g} / {errs[24]:.3g} / {errs[-1]:.3g}; limit "
        f"{TERRAIN_BASE_ATOL})")
    return {"base_err_by_step": errs, "first_contact_step": contact_from, "launches": counts}


def phase_terrain_analytic() -> dict:
    """(b) The analytic terrain: the kernel against its twin, then the terrain
    policy at cmd 1-3 x JAX's 8 seeds against the JAX lanes loop."""
    twin = _analytic_twin()
    cfg = ev._fixed_command_cfg(_analytic_cfg()).replace(crucial=False)
    params = mio.load_bp5_csv(TERRAIN_EVAL_ARTIFACT, device=DEVICE)
    K = len(JAX_ANALYTIC_SEEDS)
    cmd_of = [vx for vx in TERRAIN_COMMANDS for _ in range(K)]
    cmds = np.array([[vx, 0.0, 0.0] for vx in cmd_of], np.float32)
    seeds = torch.tensor(JAX_ANALYTIC_SEEDS * len(TERRAIN_COMMANDS), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(cfg.seed)
    ev.policy_rollout(cfg, params, cmds, gen, 2, device=DEVICE, terrain_seed=seeds)  # warm-up
    reset_counts()
    t0 = time.perf_counter()
    logr = ev.policy_rollout(cfg, params, cmds, gen, TERRAIN_STEPS, device=DEVICE,
                             terrain_seed=seeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, {**rollout_counts(TERRAIN_STEPS), "phys_analytic": TERRAIN_STEPS},
                 "17b")
    for name in ("gc", "gv", "action", "lstm_state"):
        if not torch.isfinite(getattr(logr, name)).all():
            raise RuntimeError(f"17b: non-finite {name} in the analytic-terrain rollout")
    rows = ev.tracking_rows(cfg, logr, cmd_of)
    by_cmd, failed = {}, []
    for i, vx in enumerate(TERRAIN_COMMANDS):
        mine = rows[i * K:(i + 1) * K]
        want_v, _ = JAX_ANALYTIC_LANES[vx]
        nudge = JAX_ANALYTIC_NUDGE[vx]
        v, falls = [r["v_mean"] for r in mine], sum(r["falls"] for r in mine)
        limit = max(V_TOL, 2 * nudge["spread"])
        diff = float(np.mean(v) - np.mean(want_v))
        by_cmd[vx] = {"v": v, "v_mean": float(np.mean(v)), "jax_v_mean": float(np.mean(want_v)),
                      "diff": diff, "limit": limit, "falls": falls,
                      "jax_falls_range": [min(nudge["falls"]), max(nudge["falls"])]}
        log(f"[17b] cmd {vx:.1f}: v {np.mean(v):.4f} over {K} seeds (JAX lanes "
            f"{np.mean(want_v):.4f}, diff {diff:+.4f}, limit {limit:.4f}: max(0.1, 2 x JAX's "
            f"nudge spread {nudge['spread']:.4f})), falls {falls} (JAX {nudge['falls']}); by "
            "seed " + " ".join(f"{a:.3f}/{b:.3f}" for a, b in zip(v, want_v)))
        if not (abs(diff) <= limit and min(nudge["falls"]) <= falls <= max(nudge["falls"])):
            failed.append(f"cmd {vx:g}: v {np.mean(v)} against JAX {np.mean(want_v)} (limit "
                          f"{limit}), falls {falls} against {nudge['falls']}")
    if failed:
        raise RuntimeError("17b: " + "; ".join(failed))
    log(f"[17b] {TERRAIN_STEPS} control steps x {len(cmd_of)} envs on the analytic terrain in "
        f"{wall:.2f} s: {wall / TERRAIN_STEPS * 1e3:.3f} ms a control step")
    return {"twin": twin, "by_command": by_cmd, "wall_s": wall,
            "ms_per_step": wall / TERRAIN_STEPS * 1e3, "launches": counts}


def _viewer_frames(path: str) -> int:
    """The frame count of a viewer HTML, which must load nothing from a network."""
    with open(path) as f:
        html = f.read()
    if "http://" in html or "https://" in html or "<canvas" not in html:
        raise RuntimeError(f"17c: {path} is not a self-contained viewer")
    data = json.loads(html.split("const D = ", 1)[1].split(";\n", 1)[0])
    return len(data["body"])


def phase_closures() -> dict:
    """(c) ``cli.mpc --viewer`` (srb and wb) and NumpyVecEnv's recorded video."""
    os.makedirs(CLOSURES_OUT_DIR, exist_ok=True)
    out = {}
    for engine, steps in (("srb", VIEWER_SRB_STEPS), ("wb", VIEWER_WB_STEPS)):
        path = os.path.join(CLOSURES_OUT_DIR, f"viewer_{engine}.html")
        reset_counts()
        t0 = time.perf_counter()
        res = cli_mpc.main(["--engine", engine, "--vx", "1", "--steps", str(steps), "--viewer",
                            path, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_counts(counts, physics_only_counts(steps), f"17c {engine}")
        frames = _viewer_frames(path)
        if res.get("viewer") != path or frames != -(-steps // 5):
            raise RuntimeError(f"17c: --engine {engine} viewer {res.get('viewer')} with {frames} "
                               f"frames for {steps} steps")
        log(f"[17c] cli.mpc --engine {engine} --steps {steps} --viewer: {frames} frames, "
            f"{os.path.getsize(path)} bytes, {wall:.1f} s")
        out[engine] = {"frames": frames, "bytes": os.path.getsize(path), "wall_s": wall,
                       "launches": counts}
    env = vec.NumpyVecEnv(config.train_default().replace(num_envs=VIDEO_ENVS), seed=0,
                          device=DEVICE)
    gif = os.path.join(CLOSURES_OUT_DIR, "video.gif")
    t0 = time.perf_counter()
    env.start_recording_video(gif)
    for _ in range(VIDEO_STEPS):
        env.step(np.zeros((VIDEO_ENVS, 12), np.float32))
    captured = np.stack(env._video_gc) if env._video_gc else np.zeros((0, 19))
    if captured.shape != (VIDEO_STEPS, 19) or not np.isfinite(captured).all():
        raise RuntimeError(f"17c: NumpyVecEnv captured {captured.shape} states")
    if HAS_MATPLOTLIB:
        from PIL import Image
        env.stop_recording_video()
        with Image.open(gif) as img:
            frames = img.n_frames
        if frames != -(-VIDEO_STEPS // 10):
            raise RuntimeError(f"17c: {gif} holds {frames} frames for {VIDEO_STEPS} steps")
        log(f"[17c] NumpyVecEnv recorded {VIDEO_STEPS} steps of env 0 to {frames} GIF frames "
            f"({os.path.getsize(gif)} bytes)")
        out["video"] = {"frames": frames, "bytes": os.path.getsize(gif)}
    else:   # the render is host-side matplotlib (analysis/figures.rollout_animation)
        try:
            env.stop_recording_video()
            raise RuntimeError("17c: the video rendered without matplotlib")
        except ModuleNotFoundError as e:
            if e.name != "matplotlib":
                raise
        log(f"[17c] NumpyVecEnv captured {VIDEO_STEPS} states of env 0 on the card and handed "
            "them to figures.rollout_animation, which needs matplotlib: this machine has none, "
            "so no GIF (the CPU tests render it, tests/test_torch_vec.py)")
        out["video"] = {"frames": None, "captured": VIDEO_STEPS,
                        "not_rendered": "no matplotlib on this machine"}
    out["video"]["wall_s"] = time.perf_counter() - t0
    return out

# --- phase 18 -----------------------------------------------------------------

def _rollout_bits(batch: ppo.Batch, block: int) -> list:
    """(T, blocks, 5): for each control step and block of ``block`` envs, the
    exact integer sum of the bits of the rollout's obs, actions, values,
    neglogpacs and rewards."""
    cols = []
    for x in (batch.obs, batch.actions, batch.values, batch.neglogpacs, batch.rewards):
        T, B = x.shape[:2]
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        cols.append(bits.reshape(T, B // block, -1).sum(-1))
    return torch.stack(cols, -1).cpu().tolist()


def _dist_solve(mesh, sharded, single, trajectory: str) -> dict:
    """A sharded solve against the unsharded one in this process: the worst
    relative cost error, the worst absolute error of the plan (``us``) and
    the worst error of ``trajectory`` relative to its largest entry, which
    problems differ at all, and the times (from a collective that lines the
    ranks up)."""
    device = mesh.device
    pmesh.all_reduce_sum(mesh, torch.zeros(1, device=device))
    t0 = _sync(device)
    got = sharded()
    t1 = _sync(device)
    want = single()
    t2 = _sync(device)
    for k, v in want._asdict().items():
        if v is not None and not (got._asdict()[k].shape == v.shape and
                                  bool(torch.isfinite(got._asdict()[k]).all())):
            raise RuntimeError(f"sharded solve: {k} of shape {tuple(got._asdict()[k].shape)}, "
                               f"want {tuple(v.shape)}, or not finite")
    n = int(want.cost.shape[0])
    differ = torch.zeros(n, dtype=torch.bool, device=device)
    for k in ("cost", "us", trajectory):
        differ |= (getattr(got, k) != getattr(want, k)).reshape(n, -1).any(1)
    rows = differ.nonzero()[:, 0].tolist()
    traj_got, traj_want = getattr(got, trajectory), getattr(want, trajectory)
    extra = {} if trajectory != "xs" else {   # the positions, which JAX's fleet test holds
        "gc_abs": float((traj_got[..., :19] - traj_want[..., :19]).abs().max())}
    return {**extra, "problems": n, "ms": (t1 - t0) * 1e3, "single_ms": (t2 - t1) * 1e3,
            "cost_rel": float(((got.cost - want.cost).abs() / want.cost.abs()).max()),
            "plan_abs": float((got.us - want.us).abs().max()), "trajectory": trajectory,
            "trajectory_abs": float((traj_got - traj_want).abs().max()),
            "trajectory_rel": float((traj_got - traj_want).abs().max() / traj_want.abs().max()),
            "problems_differing": len(rows), "differing_range": rows[:1] + rows[-1:]}


def phase18_rank(spec_path: str) -> int:
    """One rank of phase 18 (``--phase18-rank SPEC``; the launcher's
    environment names the rank): ``cli.train`` with the spec's arguments
    (``--distributed``) in this process, its launches counted around it and
    each update's metrics, the rollout's bits and the final parameters kept;
    then the sharded SRB solve and, at world 2, the sharded whole-body solve,
    each against the unsharded solve here. Writes SPEC.rank<r>.json / .npz."""
    with open(spec_path) as f:
        spec = json.load(f)
    argv = spec["train_args"]
    device = argv[argv.index("--device") + 1]
    pmesh.init_distributed(device=device, backend=spec["backend"])
    mesh = pmesh.make_mesh(device)
    updates, bits, last = [], [], {}
    make, rollout = ppo.make_update_fn, ppo.rollout

    def kept_update(*a, **k):
        update = make(*a, **k)

        def run(ts):
            ts, metrics = update(ts)
            updates.append({k: float(v) for k, v in metrics.items()})
            last["params"] = ts.params
            return ts, metrics
        return run

    def kept_rollout(*a, **k):
        out = rollout(*a, **k)
        bits.append(_rollout_bits(out[1], spec["block"]))
        return out
    ppo.make_update_fn, ppo.rollout = kept_update, kept_rollout
    try:
        reset_counts()
        t0 = time.perf_counter()
        cli_train.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        ppo.make_update_fn, ppo.rollout = make, rollout
    rec = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend, "wall_s": wall,
           "launches": counts, "updates": updates, "rollout_bits": bits,
           "checksum": pmesh.checksum(last["params"].leaves())}
    dev = mesh.device
    cfg = config.test_default()
    scfg = srb.SRBConfig(horizon=spec["srb"][1])
    probs = srb_bench_problems(cfg, spec["srb"][0], dev)
    rec["srb"] = _dist_solve(mesh, lambda: ptrain.make_distributed_srb(cfg, scfg, mesh)(probs),
                             lambda: srb.batched_solve(cfg, scfg, probs), "forces")
    if mesh.world > 1:
        wcfg = config.test_default().replace(obs_noise=0.0)
        mc = trot.MPCConfig(**spec["mpc"][1])
        wprobs = wb_problems(wcfg, spec["mpc"][0], mc.horizon, dev)
        robot = mdl.nominal_params(wcfg, device=dev)
        rec["mpc"] = _dist_solve(
            mesh, lambda: ptrain.make_distributed_mpc(wcfg, mc, mesh)(robot, wprobs),
            lambda: trot.batched_solve(wcfg, mc, robot, wprobs), "xs")
    pmesh.shutdown()
    out = f"{spec_path}.rank{mesh.rank}"
    np.savez(out + ".npz", **mio.policy_params_to_numpy(last["params"]))
    with open(out + ".json", "w") as f:
        json.dump(rec, f)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tag: str, spec: dict, world: int, live: list) -> list:
    """Phase 18's ranks of ``spec``: at world 1 one process under
    ``torch.distributed.run --standalone``; else ``world`` processes with the
    launcher's variables set by hand, each with ``LOCAL_RANK=0`` (one card).
    Returns each rank's (record, parameters); raises, with the end of its
    log, if a rank fails or outlives DIST_TIMEOUT_S. The processes are added
    to ``live`` while they run."""
    os.makedirs(DIST_LOG_DIR, exist_ok=True)
    spec_path = os.path.join(DIST_LOG_DIR, f"{tag}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    me = os.path.abspath(__file__)
    if world == 1:
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "1", me, "--phase18-rank", spec_path]]
        envs = [dict(os.environ)]
    else:
        port = _free_port()
        cmds = [[sys.executable, me, "--phase18-rank", spec_path]] * world
        envs = [{**os.environ, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)} for r in range(world)]
    logs = [os.path.join(DIST_LOG_DIR, f"{tag}.{r}.log") for r in range(len(cmds))]
    procs = []
    for c, e, path in zip(cmds, envs, logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(c, env=e, stdout=out, stderr=subprocess.STDOUT,
                                          start_new_session=True))
    live.extend(procs)
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for path, p in zip(logs, procs):
        if p.returncode != 0:
            with open(path) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"phase 18 ({tag}): {os.path.basename(path)} exited {p.returncode} "
                               f"(a timeout kills at {DIST_TIMEOUT_S} s):\n{tail}")
    out = []
    for r in range(world):
        with open(f"{spec_path}.rank{r}.json") as f:
            out.append((json.load(f), dict(np.load(f"{spec_path}.rank{r}.npz"))))
    return out


def first_update_of(run_dir: str) -> tuple[dict, dict]:
    """A cli.train run's first metrics.jsonl row and the parameters of its
    checkpoint after that update (ckpt_1.pkl)."""
    rows = metrics_io.read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    params, _, step = mio.load_checkpoint(os.path.join(run_dir, "ckpt_1.pkl"), "cpu")
    if step != 1:
        raise RuntimeError(f"{run_dir}/ckpt_1.pkl holds update {step}")
    return rows[0], mio.policy_params_to_numpy(params)


def _held_metrics(got: dict, want: dict, what: str) -> float:
    """Every metric of ``want`` but times and counters within DIST_ATOL +
    DIST_RTOL relative; returns the worst relative error."""
    worst = 0.0
    for k, w in want.items():
        if k.startswith("time_") or k in ("fps", "timesteps", "lr"):
            continue
        g = got[k]
        if not (np.isfinite(g) and abs(g - w) <= DIST_ATOL + DIST_RTOL * abs(w)):
            raise RuntimeError(f"{what}: {k} {g} against {w} (limit {DIST_RTOL:g} relative)")
        worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
    return worst


def _held_params(got: dict, want: dict, what: str) -> float:
    """Every leaf within DIST_RTOL of its largest entry; returns the worst."""
    worst = 0.0
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max()) / float(np.abs(w).max())
        if not err <= DIST_RTOL:
            raise RuntimeError(f"{what}: parameter {k} off by {err:.3g} of its largest entry "
                               f"(limit {DIST_RTOL:g})")
        worst = max(worst, err)
    return worst


def _held_solve(r: dict, what: str, whole_body: bool) -> None:
    """The SRB solve: costs, plans and forces (relative to the largest) at
    DIST_SOLVE_*; the whole-body one: costs at DIST_SOLVE_RTOL, plans and
    positions (gc) within WB_FLEET_ATOL."""
    plan_atol = WB_FLEET_ATOL if whole_body else DIST_SOLVE_ATOL
    traj, traj_limit = (("gc_abs", WB_FLEET_ATOL) if whole_body
                        else ("trajectory_rel", DIST_SOLVE_RTOL))
    if not (r["cost_rel"] <= DIST_SOLVE_RTOL and r["plan_abs"] <= plan_atol
            and r[traj] <= traj_limit):
        raise RuntimeError(f"{what}: costs within {r['cost_rel']:.3g} relative, plans within "
                           f"{r['plan_abs']:.3g}, {traj} {r[traj]:.3g} (limits "
                           f"{DIST_SOLVE_RTOL:g}, {plan_atol:g}, {traj_limit:g})")
    log(f"[18c] {what}: {r['problems']} problems, {r['ms']:.1f} ms sharded (all-gather included) "
        f"against {r['single_ms']:.1f} ms in one solve; costs within {r['cost_rel']:.3g} "
        f"relative, plans (us) within {r['plan_abs']:.3g}, {r['trajectory']} within "
        f"{r['trajectory_abs']:.3g} ({r['trajectory_rel']:.3g} of its largest entry"
        + (f"; positions within {r['gc_abs']:.3g}" if whole_body else "") + "); "
        f"{r['problems_differing']} problems not bit for bit (first and last: "
        f"{r['differing_range']})")


def _first_parted(bits_a: list, bits_b: list, block: int):
    """The first (step, field) where a rank's rollout bits part from world
    1's block ``block``; None if none does."""
    fields = ("obs", "actions", "values", "neglogpacs", "rewards")
    for t, (a, b) in enumerate(zip(bits_a, bits_b)):
        for j, name in enumerate(fields):
            if a[block][j] != b[0][j]:
                return {"step": t, "field": name}
    return None


def phase_distributed(training: dict, live: list) -> dict:
    """cli.train --distributed at world 1 over NCCL and at world 2 over gloo
    on the one card (phase 7's arguments, one update), and the sharded solves;
    the rank processes go to ``live`` while they run."""
    want_metrics, want_params = first_update_of(os.path.join(ROOT, training["run_dir"]))
    spec = {"block": DIST_BLOCK, "srb": [SRB_BATCH, SRB_HORIZON],
            "mpc": [DIST_MPC_B, WB_FLEET_MC]}
    argv = lambda world: train_argv(1, os.path.join(DIST_LOG_DIR, f"w{world}")) + [  # noqa: E731
        "--distributed"]
    launches = {"phys_substep": PHYS_LAUNCHES_PER_STEP * TRAIN_STEPS,
                "lstm_cell": LSTM_LAUNCHES_PER_STEP * (TRAIN_STEPS + 1),
                "lstm_seq_train": LSTM_LAYERS * TRAIN_EPOCHS,
                "lstm_seq_bwd": LSTM_LAYERS * TRAIN_EPOCHS}

    t0 = time.perf_counter()
    (a, pa), = _run_ranks("a", {**spec, "backend": None, "train_args": argv(1)}, 1, live)
    wall_a = time.perf_counter() - t0
    if a["backend"] != pmesh.default_backend(DEVICE) or a["world"] != 1:
        raise RuntimeError(f"18a: world {a['world']} over {a['backend']}")
    check_counts(a["launches"], launches, "18a")
    m_a = a["updates"][0]
    err_a = {"metrics": _held_metrics(m_a, want_metrics, "18a against phase 7"),
             "params": _held_params(pa, want_params, "18a against phase 7")}
    bitwise_a = all(pa[k].tobytes() == want_params[k].tobytes() for k in want_params)
    log(f"[18a] world 1 over {a['backend']} (torch.distributed.run, {wall_a:.1f} s in all): "
        f"{m_a['time_rollout_s']:.2f} s rollout + {m_a['time_gae_s']:.3f} s GAE + "
        f"{m_a['time_epochs_s']:.2f} s epochs ({m_a['time_collectives_s']:.3f} s in collectives); "
        f"against phase 7's first update: metrics within {err_a['metrics']:.3g} relative, "
        f"parameters within {err_a['params']:.3g} of each leaf's largest entry (limit "
        f"{DIST_RTOL:g}; bit for bit {bitwise_a})")

    t0 = time.perf_counter()
    ranks = _run_ranks("b", {**spec, "backend": "gloo", "train_args": argv(2)}, 2, live)
    wall_b = time.perf_counter() - t0
    (b0, p0), (b1, p1) = ranks
    parted = [_first_parted(a["rollout_bits"][0], b["rollout_bits"][0], r)
              for r, (b, _) in enumerate(ranks)]
    log("[18b] each rank's rollout against its block of 18a's: "
        + ("bit for bit" if not any(parted) else f"parts at {parted}"))
    if {b0["checksum"]} != {b1["checksum"]} or any(
            p0[k].tobytes() != p1[k].tobytes() for k in p0):
        raise RuntimeError("18b: the ranks' parameters differ")
    strip = lambda m: {k: v for k, v in m.items() if not k.startswith("time_")}  # noqa: E731
    if strip(b0["updates"][0]) != strip(b1["updates"][0]):
        raise RuntimeError("18b: the ranks report different metrics")
    err_b = {"metrics": _held_metrics(b0["updates"][0], m_a, "18b against 18a"),
             "params": _held_params(p0, pa, "18b against 18a")}
    per_rank = []
    for b, _ in ranks:
        check_counts(b["launches"], launches, f"18b rank {b['rank']}")
        m = b["updates"][0]
        per_rank.append({k: m[k] for k in ("time_rollout_s", "time_gae_s", "time_epochs_s",
                                           "time_collectives_s")})
        log(f"[18b] rank {b['rank']} of 2 over {b['backend']}, {FULL_B // 2} envs: "
            f"{m['time_rollout_s']:.2f} s rollout + {m['time_gae_s']:.3f} s GAE + "
            f"{m['time_epochs_s']:.2f} s epochs, {m['time_collectives_s']:.3f} s of it in "
            f"collectives (staged through the host)")
    log(f"[18b] world 2 on one card ({wall_b:.1f} s in all): parameters bit for bit alike on "
        f"the ranks; against world 1 metrics within {err_b['metrics']:.3g} relative, parameters "
        f"within {err_b['params']:.3g} (limit {DIST_RTOL:g}); rollout blocks "
        + ("bit for bit world 1's" if not any(parted) else f"part from world 1's at {parted}")
        + ". Two ranks on one card share its SMs and the host's cores: this measures no "
        "scaling, only that W ranks compute what one does and what the collectives cost")

    _held_solve(a["srb"], f"make_distributed_srb at world 1 over {a['backend']}", False)
    for b, _ in ranks:
        _held_solve(b["srb"], f"make_distributed_srb rank {b['rank']} of 2", False)
        _held_solve(b["mpc"], f"make_distributed_mpc rank {b['rank']} of 2", True)
    return {"launches": a["launches"], "world1": {"wall_s": wall_a, "backend": a["backend"],
                                                   "metrics": m_a, "err_vs_phase7": err_a,
                                                   "bitwise_vs_phase7": bitwise_a},
            "world2": {"wall_s": wall_b, "backend": b0["backend"], "metrics": b0["updates"][0],
                       "err_vs_world1": err_b, "seconds_by_rank": per_rank,
                       "rollout_parted": parted, "launches": [b["launches"] for b, _ in ranks]},
            "srb": {"world1": a["srb"], "world2": [b["srb"] for b, _ in ranks]},
            "mpc": [b["mpc"] for b, _ in ranks]}


def _phase18_alone() -> list:
    """Phase 18 without the main run: phase 7's first update as its reference."""
    ref = {}

    def reference():
        run_dir = cli_train.main(train_argv(1, os.path.join(DIST_LOG_DIR, "reference")))
        ref["run_dir"] = os.path.relpath(run_dir, ROOT)
        return ref
    return [("7 (one update)", reference), ("18", lambda: phase_distributed(ref, []))]


def _phase17() -> list:
    return [("17a", phase_reftraj), ("17b", phase_terrain_analytic), ("17c", phase_closures)]


def _phase16() -> list:
    return [("16a", phase_landscape), ("16b", phase_entropy_kappa), ("16c", phase_kappa),
            ("16d", phase_cli_modes)]


def _phase14() -> list:
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    return [("14a", phase_wb_fleet), ("14b", phase_wb_track),
            ("14c", lambda: phase_wb_parity(params))]


def _phase15() -> list:
    return [("15a", lambda: phase_perenv_eval("hard")),
            ("15b", lambda: phase_perenv_eval("crucial")),
            ("15c", phase_perenv_training), ("15d", phase_ppo3), ("15e", phase_perenv_timing)]


def _phases10to12() -> list:
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    return [("10", phase_terrain_eval), ("11", phase_terrain_training),
            ("12", lambda: phase_parity(params))]


def worker(out_path: str, phases: list) -> int:
    """Run ``phases`` ((name, fn) pairs) and write their records to
    ``out_path``. The main run starts one such process with phases 14a-c,
    15, 10-12 and 16a (``--side-worker``) alongside phases 7, 8, 16b, 16c,
    9, 13, 17a-c, 16d and 14d (host-bound loops of one Python thread each,
    the card mostly idle), so the script stays inside its time limit; each path's
    launches are counted in this process, around its own run. (Phase 15 in a
    third process slowed the others by a third: PERF.md.)"""
    seconds, rec = {}, {}
    for name, fn in phases:
        t0 = time.perf_counter()
        rec[name] = fn()
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] {seconds[name]:.1f} s (second process)")
    with open(out_path, "w") as f:
        json.dump({**rec, "seconds": seconds}, f, default=str)
    return 0


class _Phase18:
    """Phase 18 (:func:`phase_distributed`) in a thread of this process,
    started on entry: its ranks are processes of their own, host-bound as
    phase 13 is, so they run beside it. :meth:`result` waits and raises what
    the phase raised; leaving kills any rank still running."""

    def __init__(self, training: dict):
        self.training, self.procs, self.out, self.err = training, [], None, None

    def _body(self):
        try:
            self.out = phase_distributed(self.training, self.procs)
        except BaseException as e:   # handed to the main thread by result()
            self.err = e

    def __enter__(self):
        self.thread = threading.Thread(target=self._body, daemon=True)
        self.thread.start()
        return self

    def result(self) -> dict:
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()


class _SideWorker:
    """The second process of :func:`worker` (``--side-worker``, phases 14a-c,
    15, 10-12 and 16a): started on entry, waited for by :meth:`result`, killed if the
    main run leaves before that."""

    def __enter__(self):
        self.path = os.path.join(ROOT, "build", f"chip_smoke_side_{os.getpid()}.json")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                      "--side-worker", self.path])
        return self

    def result(self) -> dict:
        if self.proc.wait() != 0:
            raise RuntimeError(f"the second process exited {self.proc.returncode}")
        with open(self.path) as f:
            return json.load(f)

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.path):
            os.remove(self.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU")
    ap.add_argument("--out", default=None, help="also write all measurements to this JSON file")
    ap.add_argument("--side-worker", default=None, metavar="PATH",
                    help="run only phases 14a-c, 15, 10-12 and 16a and write their "
                    "records to PATH (the main run starts this itself)")
    ap.add_argument("--perenv-worker", default=None, metavar="PATH",
                    help="run only phase 15 and write its records to PATH")
    ap.add_argument("--phase16-worker", default=None, metavar="PATH",
                    help="run only phases 2, 3 and 16 and write their records to PATH")
    ap.add_argument("--phase17-worker", default=None, metavar="PATH",
                    help="run only phases 2, 3 and 17 and write their records to PATH")
    ap.add_argument("--phase18-worker", default=None, metavar="PATH",
                    help="run only phases 2, 3 and 18 (with phase 7's first update as its "
                    "reference) and write their records to PATH")
    ap.add_argument("--phase18-rank", default=None, metavar="SPEC",
                    help="one rank of phase 18 (the phase starts these itself)")
    args = ap.parse_args(argv)
    out_path = args.out
    if args.phase18_rank:   # a rank runs on the device its spec names
        return phase18_rank(args.phase18_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA GPU",
              file=sys.stderr)
        return 1
    if args.side_worker:
        return worker(args.side_worker, _phase14() + _phase15() + _phases10to12()
                      + [("16a", phase_landscape)])
    if args.perenv_worker:
        return worker(args.perenv_worker, _phase15())
    if args.phase16_worker:
        return worker(args.phase16_worker, [("2", phase_build), ("3", phase_kernels)] + _phase16())
    if args.phase17_worker:
        return worker(args.phase17_worker, [("2", phase_build), ("3", phase_kernels)] + _phase17())
    if args.phase18_worker:
        return worker(args.phase18_worker, [("2", phase_build), ("3", phase_kernels)]
                      + _phase18_alone())

    start, seconds = time.perf_counter(), {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}] {seconds[name]:.1f} s; {time.perf_counter() - start:.1f} s in all")
        return out
    smi = run("1", phase_environment)
    build = run("2", phase_build)
    kern = run("3", phase_kernels)
    serving = run("4", phase_serving)
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    full = run("5", phase_full_width, params, {
        "phys_substep": kern["phys_substep"]["ms"],
        "lstm_cell": statistics.mean(p["ms"] for p in kern["lstm_cell"]["per_launch"].values())})
    bptt = run("6", phase_bptt)
    # phases 14a-c, 15, 10-12 and 16a beside 7-9, 16b, 16c, 13, 17a-c, 16d and 14d (the
    # last three here, where the second process was the longer); phase 18's ranks beside
    # 13, 17a and 17b
    with _SideWorker() as side_worker:
        training = run("7", phase_training)
        solve = run("8", phase_batched_solve)
        p16 = {"16b": run("16b", phase_entropy_kappa), "16c": run("16c", phase_kappa)}
        mpc = run("9", phase_mpc)
        with _Phase18(training) as p18:   # its ranks run beside phase 13
            wholebody = run("13", phase_wholebody)
            p17 = {"17a": run("17a", phase_reftraj), "17b": run("17b", phase_terrain_analytic)}
            distributed = run("18", p18.result)
        p17["17c"] = run("17c", phase_closures)
        p16["16d"] = run("16d", phase_cli_modes)
        wb_terrain = run("14d", phase_wb_terrain)
        side = run("side", side_worker.result)
    terrain_eval, terrain_training, parity_rec = side["10"], side["11"], side["12"]
    wb_fleet, wb_track, wb_parity = (side[k] for k in ("14a", "14b", "14c"))
    pe = {k: side[k] for k in ("15a", "15b", "15c", "15d", "15e")}
    p16["16a"] = side["16a"]
    (perenv_training, perenv_variants), (ppo3_lstm, ppo3_mlp) = pe["15c"], pe["15d"]
    seconds.update({f"{k} (second process)": v for k, v in side["seconds"].items()})

    # entry: the kernel function that `launches` counts and the record's times read; path:
    # the main path that launches it, whose own run `launches` was read after. An entry the
    # main path launches at two shapes gives the times of the shape farthest from its bound
    # (`shape`) and both under `per_launch`
    phys_src = "high_speed_quadrupedal_locomotion_by_irrl_torch/csrc/phys_substep.cu"
    lstm_src = "high_speed_quadrupedal_locomotion_by_irrl_torch/csrc/lstm_cell.cu"
    lstm_repl = "high_speed_quadrupedal_locomotion_by_irrl_tpu/ops/lstm_pallas.py:26"
    sources = {
        "phys_substep": (phys_src, "high_speed_quadrupedal_locomotion_by_irrl_tpu/ops/phys_pallas.py:71",
                         "phys_control_step_kernel", "serving"),
        "lstm_cell": (lstm_src, lstm_repl, "lstm_cell_pair_kernel", "serving"),
        # the two entries only training launches, one a layer over the whole sequence: the
        # same TPU kernel's forward (under lax.scan) with the gates kept, and its gradient,
        # which the JAX package leaves to XLA's transpose
        "lstm_seq_train": (lstm_src, lstm_repl, "lstm_seq_train_kernel", "training"),
        "lstm_seq_bwd": (lstm_src, "high_speed_quadrupedal_locomotion_by_irrl_tpu/models/lstm.py:83 "
                         "(the cell's transpose under jax.grad; no TPU kernel)",
                         "lstm_seq_bwd_kernel", "training"),
        # the same TPU kernel under the landscape's jax.vmap over blended weight sets
        "lstm_cell_rows": (lstm_src, lstm_repl, "lstm_cell_pair_rows_kernel", "landscape")}
    runs = {"serving": serving, "full_width": full, "training": training, "mpc": mpc,
            "terrain_eval": terrain_eval, "terrain_training": terrain_training,
            "parity": parity_rec, "wb_dense": wholebody["dense_frozen"],
            "wb_lanes_frozen": wholebody["lanes_frozen"], "wb_lanes_fd": wholebody["lanes_fd"],
            "wb_fleet": wb_fleet, "wb_track": wb_track, "mpc_vs_bp5": wb_parity,
            "wb_terrain": wb_terrain, "perenv_hard_eval": pe["15a"],
            "perenv_crucial_eval": pe["15b"], "perenv_training": perenv_training,
            "perenv_training_variants": perenv_variants, "ppo3_lstm": ppo3_lstm,
            "ppo3_mlp": ppo3_mlp, "landscape": p16["16a"], "entropy_kappa": p16["16b"],
            "kappa": p16["16c"], "cli_modes": p16["16d"], "teleop": p16["16d"]["teleop"],
            "reftraj": p17["17a"], "terrain_analytic_twin": p17["17b"]["twin"],
            "terrain_analytic": p17["17b"], "viewer_srb": p17["17c"]["srb"],
            "viewer_wb": p17["17c"]["wb"], "distributed": distributed}
    extras = ("shape", "per_launch", "call_ms", "plain_call_ms", "library_call_ms", "substep_ms",
              "substep_plain_ms", "substep_bound_ms", "substep_bound_by", "substep_max_abs_err",
              "c2t_ms", "c2t_pd_path_ms", "c2t_bound_ms", "c2t_bound_by", "c2t_max_abs_err",
              "c2t_null_bitwise", "terrain_ms", "terrain_flat_ms", "terrain_plain_ms",
              "terrain_bound_ms", "terrain_bound_by", "terrain_max_abs_err",
              "terrain_zero_bitwise", "analytic_ms", "analytic_flat_ms", "analytic_plain_ms",
              "analytic_bound_ms", "analytic_bound_by", "analytic_max_abs_err", "analytic_ptxas",
              "ptxas_map", "ptxas_substep", "wb_max_abs_err", "wb_widths",
              "cell_shape", "cell_ms", "cell_plain_ms", "cell_bound_ms", "cell_bound_by",
              "cell_library_ms", "cell_max_abs_err", "cell_per_launch", "ms_a_step",
              "ptxas", "smem_bytes", "bitwise_equal_to_inference")
    kernels = []
    for name, (src, repl, entry, path) in sources.items():
        k = kern[name]
        if runs[path]["launches"][name] < 1:
            raise RuntimeError(f"{name}: the {path} path launched it no time")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": runs[path]["launches"][name], "path": path, "entry": entry,
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        **{f"launches_{r}": run["launches"][name] for r, run in runs.items()},
                        **{f: k[f] for f in extras if f in k}})
    # the analytic ground is an instantiation of the physics kernel: its own count of launches
    if p17["17b"]["launches"]["phys_analytic"] < 1:
        raise RuntimeError("phys_substep: the analytic-terrain path launched its mode no time")
    kernels[0]["analytic_launches"] = {r: run["launches"].get("phys_analytic", 0)
                                       for r, run in runs.items()}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "build": build, "kernels": kern, "serving": serving,
                       "full_width": full, "bptt": bptt, "training": training,
                       "batched_solve": solve, "mpc": mpc, "terrain_eval": terrain_eval,
                       "terrain_training": terrain_training, "parity": parity_rec,
                       "wholebody": wholebody, "wb_fleet": wb_fleet, "wb_track": wb_track,
                       "wb_parity": wb_parity, "wb_terrain": wb_terrain, "perenv": pe,
                       "phase16": p16, "phase17": p17, "phase18": distributed,
                       "seconds_by_phase": seconds}, f, indent=1,
                      default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
