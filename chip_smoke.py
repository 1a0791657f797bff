"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: both hand-written kernels from csrc/ with nvcc (in parallel), with
   ptxas' register and spill report;
3. kernel checks: every kernel entry point against its plain PyTorch version
   on the card (the LSTM's training-mode forward and its backward kernel
   against autograd of the plain cells: outputs, dx, dc, dh, dgates and the
   weight gradients), at the main path's shapes and two ragged batches, then timed
   (torch.profiler's device time, median of 30 launches) beside its plain
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
   within 0.1 m/s of the JAX package's;
5. full width: a 1024-env closed-loop rollout for 200 control steps, commands
   spread over 0-5 m/s, with env-steps/s, each kernel's share of device time,
   the fall count, and the PyTorch ops the host dispatches a control step,
   split by where they are dispatched;
6. BPTT: on a 32-step rollout's batch at 1024 envs, ``ppo_loss`` and the
   gradient of every parameter leaf through the kernels against the plain
   cells under autograd, with the launch counts checked (2 training-mode
   forward and 2 backward launches a step of ``sequence``);
7. training at full width: the port's ``cli.train`` for a few updates at 1024
   envs x 750 steps x 10 epochs, warm-started from the flagship export, with
   the launch counts of all four kernels checked, every metric finite, the
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
10. ``analysis.parity.srb_vs_bp5`` at cmd 1 on the flagship artifact (through
   the LSTM and physics kernels) against the JAX package's on the CPU.

Phase 3 also holds the control step with its Convert2Torque inputs (a torque
feedforward and a PD scale) against its plain loop, at the closed loop's
impulse scale, and checks that leaving them out is bit for bit a feedforward
of 0 and a scale of 1.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every
measurement to a JSON file. Needs no JAX and imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from high_speed_quadrupedal_locomotion_by_irrl_torch import config
from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import parity
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import mpc as cli_mpc
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as cli_test
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import train as cli_train
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime as mpc_runtime
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import srb
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import (
    _build, lstm_cuda, pd_torque, phys_cuda,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl
from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import metrics as metrics_io

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
TRAIN_UPDATES, TRAIN_STEPS, TRAIN_EPOCHS = 3, 750, 10
TRAIN_LOG_DIR = os.path.join(ROOT, "runs", "chip_smoke")
BPTT_STEPS = 32      # the plain path's autograd graph at 750 steps would not be a fair use of memory
BWD_TIMING_STEPS = 8  # a short sequence: all but its last step's launch read what a step of BPTT reads
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


def device_ms(fn, reps: int, kernel: str | None = None, tries: int = 5) -> float | None:
    """Device time of one call from torch.profiler's CUDA events: the median
    duration of the named kernel's launches, or else all of a call's device
    time, as the mean event times the events a call. The profiler can lose
    events of a window (seen: 4 of 90 to 930 in every window that follows long
    ones in the same process; once about half), and a plain sum then reads
    low: a window that lacks more than 4 events or a tenth of them to a
    whole number a call, or holds no device event at all, is profiled again
    (up to ``tries`` windows); None if none would do."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernel is not None:
            durs = [(n, d) for n, d in durs if kernel in n]
        if durs and kernel is not None:
            return statistics.median(d for _, d in durs)
        per_call = -(-len(durs) // reps)
        if durs and per_call * reps - len(durs) <= max(4, per_call * reps // 10):
            return statistics.mean(d for _, d in durs) * per_call
    return None


def timings(fn, reps: int = REPS, kernel: str | None = None) -> dict:
    """``ms``: device time (CUDA events where the profiler saw none);
    ``call_ms``: CUDA events around one call, the host's issue time included."""
    call = time_ms(fn, reps)
    dev = device_ms(fn, reps, kernel)
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


def phys_ops_per_env(n_substeps: int, pd_law: bool, motor_dynamics: bool = False) -> int:
    """Arithmetic operations one env needs for ``n_substeps`` physics substeps,
    each after a PD torque if ``pd_law``: a multiply, an add and a compare
    count one each (a fused multiply-add two), as do a square root, a
    division, a sine, a cosine and a tanh. Counted by hand on the algorithm of
    csrc/phys_substep.cu, with the base body's terms and the 6x6 solve taken
    once an env: composite RNEA and CRBA about the world origin and the
    leg-first solve of the block-arrow mass matrix. (The plain version's
    per-body projections and dense 18x18 Cholesky take some 2.6 times as
    many, which the function does not need.)"""
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
    return n_substeps * (4 * leg + base + 12 * pd_joint)


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


def entry_record(per_launch: dict) -> dict:
    """The times of an entry point that the main path launches at more than
    one shape: ms, plain_ms, bound_ms, bound_by and library_ms are those of
    the one launch shape farthest from its own bound, named under ``shape``;
    ``per_launch`` holds every shape with its own."""
    worst = max(per_launch, key=lambda k: per_launch[k]["ms"] / per_launch[k]["bound_ms"])
    return {**per_launch[worst], "shape": worst, "per_launch": per_launch}


def kernel_medians(fn, reps: int, names, tries: int = 3) -> dict:
    """Median device time (ms) of the launches of each named kernel inside
    ``reps`` calls of ``fn``, from torch.profiler's CUDA events."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = {n: [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and n in e.name]
                for n in names}
        if all(durs.values()):
            return {n: statistics.median(d) for n, d in durs.items()}
    raise RuntimeError(f"torch.profiler saw no launch of {[n for n in names if not durs[n]]}")


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


def _check_lstm_training(rec: dict) -> None:
    """The training-mode forward and the backward kernel, through the autograd
    Function of ops.lstm_cuda.lstm_layer_sequence."""
    n = 48
    fwd_errs, same_as_inference, grad_errs, grad_rel = [], [], [], []
    for d in (35, 48):
        for B in (FULL_B, 37, 5):
            for towers, masked, need_dx in ((2, True, True), (2, False, True), (2, True, False),
                                            (1, True, True), (1, False, False)):
                leaves, run, _ = _layer_problem(B, d, towers, masked, 1, seed=B + d + towers,
                                                need_dx=need_dx)
                plain = {k: _leaf(v) for k, v in leaves.items()}
                before = (lstm_cuda.train_launches, lstm_cuda.bwd_launches)
                got, loss = run(lstm_cuda.lstm_layer_sequence, leaves)
                kept = got[0][0].grad_fn.gates   # activated gates; the backward leaves dgates here
                loss.backward()
                torch.cuda.synchronize()
                if (lstm_cuda.train_launches, lstm_cuda.bwd_launches) != (before[0] + 1,
                                                                          before[1] + 1):
                    raise RuntimeError("lstm layer: expected one training-mode forward and one "
                                       "backward launch")
                with torch.no_grad():   # the inference kernels on the same inputs
                    inference, _ = run(lstm_cuda.lstm_layer_sequence, leaves)
                probes = [torch.zeros(B, 4 * n, device=DEVICE, requires_grad=True)
                          for _ in range(towers)]
                want, loss_plain = run(lstm_cuda.lstm_layer_sequence_plain, plain, probes)
                loss_plain.backward()
                flat = lambda out: [t for pair in out for t in pair]  # noqa: E731
                for g_, i_, w_ in zip(flat(got), flat(inference), flat(want)):
                    torch.testing.assert_close(g_, i_, atol=1e-6, rtol=0)
                    torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
                same_as_inference.append(all(torch.equal(a, b)
                                             for a, b in zip(flat(got), flat(inference))))
                fwd_errs.append(max_err(flat(got), flat(want)))
                # dx, dc and dh (through the strided state), dWx, dWh, db, and dgates row by row
                pairs = [(k, leaves[k].grad, plain[k].grad) for k in leaves]
                pairs += [(f"dgates{i}", kept[i].sum(0), probes[i].grad) for i in range(towers)]
                case_errs = []
                for k, a, b in pairs:
                    scale = float(b.abs().max())
                    torch.testing.assert_close(a, b, atol=1e-5 + GRAD_RTOL * scale, rtol=0,
                                               msg=lambda m, k=k: f"{k}: {m}")
                    err = float((a - b).abs().max())
                    grad_rel.append(err / max(scale, 1e-30))
                    if k in ("xs", "state") or k.startswith("dgates"):
                        case_errs.append(err)
                grad_errs += case_errs
                log(f"[3] lstm layer B={B} d={d} towers={towers} masked={masked} dx={need_dx}: "
                    f"training-mode forward max |err| {fwd_errs[-1]:.3g} vs plain (bitwise equal "
                    f"to the inference kernel: {same_as_inference[-1]}); backward dx/dc/dh/dgates "
                    f"max |err| {max(case_errs):.3g}")

    # times at the main path's two launches: layer 1 (d = 35, no dx) and layer 2 (d = 48, dx)
    T, B = BWD_TIMING_STEPS, FULL_B
    per_d = {}
    for d, need_dx in ((35, False), (48, True)):
        leaves, run, data = _layer_problem(B, d, 2, True, T, seed=d, need_dx=need_dx,
                                           loss_on_c=False)
        med = kernel_medians(lambda: run(lstm_cuda.lstm_layer_sequence, leaves)[1].backward(),
                             REPS, ("lstm_cell_train_kernel", "lstm_cell_bwd_kernel"))
        plain = {k: _leaf(v) for k, v in leaves.items()}
        _, loss_plain = run(lstm_cuda.lstm_layer_sequence_plain, plain)
        plain_bwd = device_ms(lambda: torch.autograd.grad(loss_plain, list(plain.values()),
                                                          retain_graph=True), reps=5)
        # the yardstick: autograd's backward of torch.lstm_cell, once a tower and step
        lib = {k: _leaf(v) for k, v in leaves.items()}
        loss_lib = _torch_lstm_layer_loss(lib, data, d, 2)
        torch.testing.assert_close(loss_lib, loss_plain, atol=0, rtol=1e-5)
        lib_bwd = device_ms(lambda: torch.autograd.grad(loss_lib, list(lib.values()),
                                                        retain_graph=True), reps=5)
        if plain_bwd is None or lib_bwd is None:
            raise RuntimeError("torch.profiler saw no device time in the plain backward")
        dx_cols = d if need_dx else 0
        # a step of BPTT, both towers: gates read and dgates written, c, c', three incoming
        # gradients, the mask and [Wh^T | Wx^T] read, dc, dh and dx written
        bwd_bytes = 2 * 4 * (B * (8 * n + 7 * n + dx_cols) + 4 * n * (n + dx_cols)) + 4 * B
        bwd_ops = 2 * (2 * B * 4 * n * (n + dx_cols) + 29 * B * n)   # products; 29 a gate tail
        fwd = rec["lstm_cell"]["per_width"][d]
        train_bytes = fwd["bytes"] + 2 * 4 * B * 4 * n   # the forward's, and the gates kept
        per_d[d] = dict(
            bwd_ms=med["lstm_cell_bwd_kernel"], train_ms=med["lstm_cell_train_kernel"],
            bwd_plain_ms=plain_bwd / T, bwd_library_ms=lib_bwd / T,
            bwd_bound=bound_ms(bwd_bytes, bwd_ops), bwd_bytes=bwd_bytes, bwd_ops=bwd_ops,
            train_bound=bound_ms(train_bytes, fwd["ops"]), train_bytes=train_bytes,
            train_ops=fwd["ops"], dx=need_dx)
        p = per_d[d]
        log(f"[3] lstm_cell_bwd pair B={B} d={d} dx={need_dx}: kernel {p['bwd_ms']:.4f} ms on the "
            f"device (profiler, median of {REPS * T} launches), autograd backward of the plain "
            f"pair {p['bwd_plain_ms']:.4f} ms a step, of torch.lstm_cell once a tower "
            f"{p['bwd_library_ms']:.4f} ms a step, bound {p['bwd_bound'][0]:.5f} ms "
            f"({p['bwd_bound'][1]}: {bwd_bytes} B, {bwd_ops} ops)")
        log(f"[3] lstm_cell_train pair B={B} d={d}: kernel {p['train_ms']:.4f} ms on the device "
            f"(the inference pair launch: {fwd['ms']:.4f} ms), bound {p['train_bound'][0]:.5f} ms "
            f"({p['train_bound'][1]}: {train_bytes} B, {fwd['ops']} ops)")
    # one record an entry the training path launches, over the two layers' launch shapes
    def shape(d):
        return f"layer {1 if d == 35 else 2}: d={d}, {'dx' if per_d[d]['dx'] else 'no dx'}"
    fwd = rec["lstm_cell"]["per_width"]
    rec["lstm_cell_train"] = dict(entry_record({shape(d): dict(
        ms=p["train_ms"], plain_ms=fwd[d]["plain_ms"], bound_ms=p["train_bound"][0],
        bound_by=p["train_bound"][1], library_ms=fwd[d]["library_ms"]) for d, p in per_d.items()}),
        max_abs_err=max(fwd_errs), bitwise_equal_to_inference=all(same_as_inference),
        per_width=per_d)
    rec["lstm_cell_bwd"] = dict(entry_record({shape(d): dict(
        ms=p["bwd_ms"], plain_ms=p["bwd_plain_ms"], bound_ms=p["bwd_bound"][0],
        bound_by=p["bwd_bound"][1], library_ms=p["bwd_library_ms"]) for d, p in per_d.items()}),
        max_abs_err=max(grad_errs), max_rel_err=max(grad_rel), per_width=per_d)


def phase_kernels() -> dict:
    rec = {"phys_substep": {}, "lstm_cell": {}}
    _check_phys(rec)
    _check_lstm(rec)
    _check_lstm_training(rec)
    return rec


# --- phases 4 and 5 -----------------------------------------------------------

def reset_counts() -> None:
    phys_cuda.launches = 0
    lstm_cuda.launches = lstm_cuda.train_launches = lstm_cuda.bwd_launches = 0


def read_counts() -> dict:
    """Every wrapper's launch count, by the kernel's name in the `kernels` line."""
    torch.cuda.synchronize()
    return {"phys_substep": phys_cuda.launches, "lstm_cell": lstm_cuda.launches,
            "lstm_cell_train": lstm_cuda.train_launches, "lstm_cell_bwd": lstm_cuda.bwd_launches}


def check_counts(counts: dict, want: dict, what: str) -> None:
    if counts != want:
        raise RuntimeError(f"{what}: launches {counts}, expected {want}")
    log(f"[{what}] launches: " + ", ".join(f"{k} {v}" for k, v in counts.items()))


def rollout_counts(steps: int) -> dict:
    """What an evaluation rollout of ``steps`` control steps launches: the
    physics and the inference LSTM kernels, and no training kernel."""
    return {"phys_substep": PHYS_LAUNCHES_PER_STEP * steps,
            "lstm_cell": LSTM_LAUNCHES_PER_STEP * steps, "lstm_cell_train": 0, "lstm_cell_bwd": 0}


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
            "launches": counts}


def _kernel_device_ms(prof) -> dict:
    """Device time (ms) of the profiled window: all device events, and the
    two sources' kernels by name (phys_substep_kernel and
    phys_control_step_kernel; lstm_cell_kernel and lstm_cell_pair_kernel)."""
    out = {"phys_substep": 0.0, "lstm_cell": 0.0, "all": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        out["all"] += ms
        for k, prefix in (("phys_substep", "phys_"), ("lstm_cell", "lstm_cell_")):
            if prefix in e.name and "_kernel" in e.name:
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
         "post": (bp, "_post_substeps")})
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
    env_cfg = config.from_yaml(TRAIN_CFG).replace(num_envs=FULL_B)
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
                       {"phys_substep": 0, "lstm_cell": 0, "lstm_cell_train": 2 * BPTT_STEPS,
                        "lstm_cell_bwd": 2 * BPTT_STEPS}, "6")
    reset_counts()
    with plain_lstm_layers():
        _loss_and_grads(params, batch, ppo_cfg)
        t0 = time.perf_counter()
        loss_p, aux_p, grads_p = _loss_and_grads(params, batch, ppo_cfg)
        plain_s = time.perf_counter() - t0
    check_counts(read_counts(), dict.fromkeys(
        ("phys_substep", "lstm_cell", "lstm_cell_train", "lstm_cell_bwd"), 0), "6 plain")
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


def phase_training() -> dict:
    """cli.train at 1024 envs x 750 steps x 10 epochs, then an update's parts."""
    argv = ["--cfg", TRAIN_CFG, "--load", ARTIFACT, "--lr", "5e-4", "--num-envs", str(FULL_B),
            "--max-updates", str(TRAIN_UPDATES), "--log-dir", TRAIN_LOG_DIR, "--device", DEVICE]
    env_cfg = config.from_yaml(TRAIN_CFG).replace(num_envs=FULL_B)
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
    bptt_steps = TRAIN_UPDATES * TRAIN_EPOCHS * TRAIN_STEPS
    check_counts(counts, {
        "phys_substep": PHYS_LAUNCHES_PER_STEP * rollout_steps,
        # the rollout's steps and one bootstrap forward an update
        "lstm_cell": LSTM_LAUNCHES_PER_STEP * (rollout_steps + TRAIN_UPDATES),
        "lstm_cell_train": 2 * bptt_steps, "lstm_cell_bwd": 2 * bptt_steps}, "7")

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
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ppo.train_minibatch(ts.params, ts.opt_state, batch, ppo_cfg)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t1) * 1e3
    dev = _kernel_device_ms(prof)
    by_kernel = {"lstm_cell_train": 0.0, "lstm_cell_bwd": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in by_kernel:
                if f"{k}_kernel" in e.name:
                    by_kernel[k] += e.time_range.elapsed_us() / 1e3
    busy = dev["all"] / epoch_ms if dev["all"] > 0 else None
    log(f"[7] one epoch (loss, BPTT over {TRAIN_STEPS} steps, clip, Adam): {epoch_ms:.1f} ms under "
        f"the profiler, {oc.calls} PyTorch ops; device busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'} of it: training-mode forward "
        f"{by_kernel['lstm_cell_train']:.1f} ms, backward kernel {by_kernel['lstm_cell_bwd']:.1f} "
        f"ms, other device work {dev['all'] - sum(by_kernel.values()):.1f} ms")
    return {"run_dir": os.path.relpath(run_dir, ROOT), "wall_s": wall, "updates": rows,
            "launches": counts, "peak_memory_bytes": peak, "largest_move": max(moved.values()),
            "csv_err": csv_err, "fresh_policy_reward_per_step": fresh_reward,
            "rollout_torch_ops_per_step": rollout_ops_per_step,
            "epoch_ms_profiled": epoch_ms, "torch_ops_per_epoch": oc.calls,
            "epoch_device_busy": busy, "epoch_device_ms": dev["all"],
            "epoch_kernel_ms": by_kernel}


# --- phases 8, 9 and 10 -----------------------------------------------------------

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


def phase_batched_solve() -> dict:
    """srb.batched_solve at the JAX package's bench shape against its CPU
    results, then its rate, host ops, busy share, memory and bound."""
    cfg = config.test_default()
    scfg = srb.SRBConfig(horizon=SRB_HORIZON)
    i = np.arange(SRB_BATCH)
    cmds = np.stack([1.0 + 4.0 * (i % 17) / 16.0, 0.0 * i, 0.0 * i], -1).astype(np.float32)
    t0s = i.astype(np.float32) * np.float32(0.003)
    probs = srb.standing_problem(cfg, torch.tensor(cmds, device=DEVICE),
                                 torch.tensor(t0s, device=DEVICE))
    run = lambda: srb.batched_solve(cfg, scfg, probs)  # noqa: E731
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    check_counts(read_counts(), dict.fromkeys(
        ("phys_substep", "lstm_cell", "lstm_cell_train", "lstm_cell_bwd"), 0), "8")
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
                          "lstm_cell": 0, "lstm_cell_train": 0, "lstm_cell_bwd": 0}, "9")
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


def phase_parity(params) -> dict:
    """srb_vs_bp5 at cmd 1 on the flagship artifact against the JAX package's."""
    reset_counts()
    res = parity.srb_vs_bp5(config.test_default(), params, 1.0, device=DEVICE)
    counts = read_counts()
    steps = 200 + 50 + 1
    check_counts(counts, {**rollout_counts(steps)}, "10")
    got = {k: res[k] for k in ("mae", "mae_stance", "mae_swing")}
    for k, want in JAX_SRB_VS_BP5.items():
        log(f"[10] srb_vs_bp5 cmd 1: {k} {got[k]:.5f} (JAX {want:.5f}, diff {got[k] - want:+.2g})")
        if not abs(got[k] - want) <= SRB_VS_BP5_ATOL:
            raise RuntimeError(f"srb_vs_bp5 {k}: {got[k]} vs JAX {want}")
    return {**got, "launches": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU")
    ap.add_argument("--out", default=None, help="also write all measurements to this JSON file")
    out_path = ap.parse_args(argv).out
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA GPU",
              file=sys.stderr)
        return 1
    smi = phase_environment()
    build = phase_build()
    kern = phase_kernels()
    serving = phase_serving()
    params = mio.load_bp5_csv(ARTIFACT, device=DEVICE)
    full = phase_full_width(params, {
        "phys_substep": kern["phys_substep"]["ms"],
        "lstm_cell": statistics.mean(p["ms"] for p in kern["lstm_cell"]["per_launch"].values())})
    bptt = phase_bptt()
    training = phase_training()
    solve = phase_batched_solve()
    mpc = phase_mpc()
    parity_rec = phase_parity(params)

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
        # the two entries only training launches: the same TPU kernel's forward with the
        # gates kept, and its gradient, which the JAX package leaves to XLA's transpose
        "lstm_cell_train": (lstm_src, lstm_repl, "lstm_cell_train_kernel", "training"),
        "lstm_cell_bwd": (lstm_src, "high_speed_quadrupedal_locomotion_by_irrl_tpu/models/lstm.py:83 "
                          "(the cell's transpose under jax.grad; no TPU kernel)",
                          "lstm_cell_bwd_kernel", "training")}
    runs = {"serving": serving, "full_width": full, "training": training, "mpc": mpc,
            "parity": parity_rec}
    extras = ("shape", "per_launch", "call_ms", "plain_call_ms", "library_call_ms", "substep_ms",
              "substep_plain_ms", "substep_bound_ms", "substep_bound_by", "substep_max_abs_err",
              "c2t_ms", "c2t_pd_path_ms", "c2t_bound_ms", "c2t_bound_by", "c2t_max_abs_err",
              "c2t_null_bitwise",
              "cell_shape", "cell_ms", "cell_plain_ms", "cell_bound_ms", "cell_bound_by",
              "cell_library_ms", "cell_max_abs_err", "cell_per_launch")
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
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "build": build, "kernels": kern, "serving": serving,
                       "full_width": full, "bptt": bptt, "training": training,
                       "batched_solve": solve, "mpc": mpc, "parity": parity_rec}, f, indent=1,
                      default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
