"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: both hand-written kernels from csrc/ with nvcc (in parallel), with
   ptxas' register and spill report;
3. kernel checks: every kernel entry point against its plain PyTorch version
   on the card, at the main path's shapes and two ragged batches, then timed
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
   split by where they are dispatched.

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
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as cli_test
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import (
    _build, lstm_cuda, pd_torque, phys_cuda,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl

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


def device_ms(fn, reps: int, kernel: str | None = None, tries: int = 3) -> float | None:
    """Device time of one call from torch.profiler's CUDA events: the median
    duration of the named kernel's launches, or else all of a call's device
    time. A window in which the profiler saw no device time is profiled again
    (up to ``tries`` windows); None if it never did."""
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
        if durs:
            return (statistics.median(d for _, d in durs) if kernel is not None
                    else sum(d for _, d in durs) / reps)
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
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


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
        time_source={"substep": kt["source"], "substep_plain": pt["source"],
                     "control_step": ct["source"], "control_step_plain": cpt["source"]})
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
    # ms, plain_ms, bound_ms, library_ms and max_abs_err read the two-tower launch, the entry
    # point the main path launches once at each width, as the mean of both widths; the
    # single cell stands beside it under cell_*
    mean = lambda k: (per_d[35][k] + per_d[48][k]) / 2  # noqa: E731
    rec["lstm_cell"] = dict(
        max_abs_err=max(pair_errs), ms=mean("ms"), call_ms=mean("call_ms"),
        plain_ms=mean("plain_ms"), plain_call_ms=mean("plain_call_ms"),
        bound_ms=(per_d[35]["bound"][0] + per_d[48]["bound"][0]) / 2,
        bound_by=per_d[48]["bound"][1], library_ms=mean("library_ms"),
        library_call_ms=mean("library_call_ms"),
        cell_max_abs_err=max(errs), cell_ms=mean("cell_ms"), cell_call_ms=mean("cell_call_ms"),
        cell_plain_ms=mean("cell_plain_ms"), cell_library_ms=mean("cell_library_ms"),
        cell_bound_ms=(per_d[35]["cell_bound"][0] + per_d[48]["cell_bound"][0]) / 2,
        cell_bound_by=per_d[48]["cell_bound"][1], per_width=per_d)


def phase_kernels() -> dict:
    rec = {"phys_substep": {}, "lstm_cell": {}}
    _check_phys(rec)
    _check_lstm(rec)
    return rec


# --- phases 4 and 5 -----------------------------------------------------------

def reset_counts() -> None:
    phys_cuda.launches = 0
    lstm_cuda.launches = 0


def read_counts() -> tuple[int, int]:
    torch.cuda.synchronize()
    return phys_cuda.launches, lstm_cuda.launches


def check_counts(counts, steps: int, what: str) -> None:
    want = (PHYS_LAUNCHES_PER_STEP * steps, LSTM_LAUNCHES_PER_STEP * steps)
    if counts != want:
        raise RuntimeError(f"{what}: launches (phys, lstm) {counts}, expected {want}")
    log(f"[{what}] launches: phys_substep {counts[0]}, lstm_cell {counts[1]} "
        f"({PHYS_LAUNCHES_PER_STEP} and {LSTM_LAUNCHES_PER_STEP} per control step)")


def phase_serving() -> dict:
    argv = ["--model", ARTIFACT, "--eval", "--commands", "1,2,3,4,5",
            "--steps", str(EVAL_STEPS), "--device", DEVICE]
    reset_counts()
    t0 = time.perf_counter()
    res = cli_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, EVAL_STEPS, "4")
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
            "launches": {"phys_substep": counts[0], "lstm_cell": counts[1]}}


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


def _torch_ops_by_site(cfg, params, cmds, gen) -> dict:
    """PyTorch (aten) ops the host dispatches a control step, by where: a 2-step
    rollout less a 1-step one, with the calls counted inside the policy
    forward, step_batch's parts and, as the rest, the rollout's bookkeeping."""
    sites = {"policy": (lstm, "deterministic_action"), "step_batch": (bp, "step_batch"),
             "pre": (bp, "_pre_substeps"), "physics_call": (phys_cuda, "control_step"),
             "post": (bp, "_post_substeps")}
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
                ev.policy_rollout(cfg, params, cmds, gen, n, device=DEVICE)
            finally:
                for k, (mod, name) in sites.items():
                    setattr(mod, name, saved[k])
        tally["total"] = oc.calls
        per_n.append(tally)
    step = {k: per_n[1][k] - per_n[0][k] for k in per_n[0]}
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
    check_counts(counts, FULL_STEPS, "5")
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
        share = {k: counts[i] * kernel_ms[k] / (wall * 1e3)
                 for i, k in enumerate(("phys_substep", "lstm_cell"))}
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
            "launches": {"phys_substep": counts[0], "lstm_cell": counts[1]},
            "share": share, "device_busy": busy, "share_source": src,
            "profiled_device_ms": dev, "profiled_wall_ms": prof_wall}


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
    full = phase_full_width(params, {"phys_substep": kern["phys_substep"]["ms"],
                                     "lstm_cell": kern["lstm_cell"]["ms"]})

    # entry: the kernel function that `launches` counts and ms, plain_ms, bound_ms,
    # library_ms and max_abs_err read
    sources = {"phys_substep": ("high_speed_quadrupedal_locomotion_by_irrl_torch/csrc/phys_substep.cu",
                                "high_speed_quadrupedal_locomotion_by_irrl_tpu/ops/phys_pallas.py:71",
                                "phys_control_step_kernel"),
               "lstm_cell": ("high_speed_quadrupedal_locomotion_by_irrl_torch/csrc/lstm_cell.cu",
                             "high_speed_quadrupedal_locomotion_by_irrl_tpu/ops/lstm_pallas.py:26",
                             "lstm_cell_pair_kernel")}
    kernels = []
    for name, (src, repl, entry) in sources.items():
        k = kern[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": serving["launches"][name],
                        "entry": entry, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        "launches_full_width": full["launches"][name],
                        "call_ms": k["call_ms"], "plain_call_ms": k["plain_call_ms"],
                        "library_call_ms": k.get("library_call_ms"),
                        **{f: k[f] for f in (
                            "substep_ms", "substep_plain_ms", "substep_bound_ms",
                            "substep_bound_by", "substep_max_abs_err", "cell_ms",
                            "cell_plain_ms", "cell_bound_ms", "cell_bound_by",
                            "cell_library_ms", "cell_max_abs_err") if f in k}})
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "build": build, "kernels": kern, "serving": serving,
                       "full_width": full}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
