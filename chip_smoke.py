"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: both hand-written kernels from csrc/ with nvcc (in parallel), with
   ptxas' register and spill report;
3. kernel checks: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and a ragged batch, then timed (CUDA events,
   median of 30 launches) beside its plain version and a library yardstick;
4. serving path: the port's ``cli.test --eval`` at commands 1-5 for 2000
   control steps, with the kernels' launch counts checked (8 physics and 4
   LSTM launches a control step), no falls, and each command's mean speed
   within 0.1 m/s of the JAX package's;
5. full width: a 1024-env closed-loop rollout for 200 control steps, commands
   spread over 0-5 m/s, with env-steps/s, each kernel's share of device time
   and the fall count.

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
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as cli_test
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build, lstm_cuda, phys_cuda
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


def phase_kernels() -> dict:
    cfg = config.test_default()
    slip, dt = cfg.contact_slip_vel, cfg.simulation_dt
    rec = {"phys_substep": {}, "lstm_cell": {}}

    # physics substep: tolerances of the Pallas-vs-lanes test
    errs = []
    for B in (FULL_B, 37, 5):
        for imp in (0.0, 400.0):
            P, gc, gv, tau, bw = _phys_inputs(B, seed=B + int(imp))
            want = lanes.substep(P, gc, gv, tau, bw, slip, imp, dt)
            got = phys_cuda.substep(P, gc, gv, tau, bw, slip, imp, dt)
            torch.cuda.synchronize()
            for i, atol in enumerate((1e-5, 1e-3, 1e-5, 1e-3)):
                torch.testing.assert_close(got[i], want[i], atol=atol, rtol=0)
            for i in (4, 5):
                torch.testing.assert_close(got[i], want[i], atol=5e-3, rtol=1e-4)
            e = max_err(got, want)
            errs.append(e)
            log(f"[3] phys_substep B={B} impulse_scale={imp}: matches plain, max |err| {e:.3g}")
    P, gc, gv, tau, bw = _phys_inputs(FULL_B, seed=1)
    kt = timings(lambda: phys_cuda.substep(P, gc, gv, tau, bw, slip, 0.0, dt),
                 kernel="phys_substep_kernel")
    pt = timings(lambda: lanes.substep(P, gc, gv, tau, bw, slip, 0.0, dt), reps=3)
    ops = count_ops(lambda: lanes.substep(P, gc, gv, tau, bw, slip, 0.0, dt))
    nbytes = 4 * FULL_B * (phys_cuda.P_ROWS + 19 + 18 + 12 + 6 + phys_cuda.OUT_ROWS)
    b_ms, b_by = bound_ms(nbytes, ops)
    rec["phys_substep"] = dict(max_abs_err=max(errs), ms=kt["ms"], call_ms=kt["call_ms"],
                               plain_ms=pt["ms"], plain_call_ms=pt["call_ms"], bound_ms=b_ms,
                               bound_by=b_by, library_ms=None, bytes=nbytes, ops=ops,
                               time_source={"kernel": kt["source"], "plain": pt["source"]})
    log(f"[3] phys_substep B={FULL_B}: kernel {kt['ms']:.4f} ms on the device "
        f"({kt['source']}; {kt['call_ms']:.4f} ms a wrapper call), plain {pt['ms']:.3f} ms "
        f"device / {pt['call_ms']:.3f} ms a call, bound {b_ms:.5f} ms "
        f"({b_by}: {nbytes} B, {ops} ops)")

    # LSTM cell, the tower's two input widths
    errs, per_d = [], {}
    for d in (35, 48):
        for B in (FULL_B, 37, 5):
            w, x, c, h = _lstm_inputs(B, d, 48, seed=B + d)
            want = lstm.lstm_cell(w, x, c, h)
            got = lstm_cuda.lstm_cell(w, x, c, h)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                torch.testing.assert_close(g_, w_, atol=1e-5, rtol=0)
            errs.append(max_err(got, want))
        w, x, c, h = _lstm_inputs(FULL_B, d, 48, seed=d)
        lib = _torch_lstm_cell(w, x, c, h)
        hy, cy = lib()
        torch.testing.assert_close((cy, hy), lstm.lstm_cell(w, x, c, h), atol=1e-5, rtol=0)
        n = 48
        nbytes = 4 * (FULL_B * d + 2 * FULL_B * n + (d + n) * 4 * n + 4 * n + 2 * FULL_B * n)
        ops = count_ops(lambda: lstm.lstm_cell(w, x, c, h))
        kt = timings(lambda: lstm_cuda.lstm_cell(w, x, c, h), kernel="lstm_cell_kernel")
        pt = timings(lambda: lstm.lstm_cell(w, x, c, h))
        lt = timings(lib)
        per_d[d] = dict(ms=kt["ms"], call_ms=kt["call_ms"], plain_ms=pt["ms"],
                        plain_call_ms=pt["call_ms"], library_ms=lt["ms"],
                        library_call_ms=lt["call_ms"], bound=bound_ms(nbytes, ops),
                        bytes=nbytes, ops=ops, time_source={"kernel": kt["source"],
                                                            "plain": pt["source"],
                                                            "library": lt["source"]})
        p = per_d[d]
        log(f"[3] lstm_cell B={FULL_B} d={d}: kernel {p['ms']:.4f} ms on the device "
            f"({kt['source']}; {p['call_ms']:.4f} ms a wrapper call), plain {p['plain_ms']:.4f} "
            f"ms, torch.lstm_cell {p['library_ms']:.4f} ms ({p['library_call_ms']:.4f} ms a "
            f"call), bound {p['bound'][0]:.5f} ms ({p['bound'][1]}: {nbytes} B, {ops} ops); "
            f"max |err| {max(errs):.3g}")
    mean = lambda k: (per_d[35][k] + per_d[48][k]) / 2  # noqa: E731
    rec["lstm_cell"] = dict(
        max_abs_err=max(errs), ms=mean("ms"), call_ms=mean("call_ms"),
        plain_ms=mean("plain_ms"), plain_call_ms=mean("plain_call_ms"),
        bound_ms=(per_d[35]["bound"][0] + per_d[48]["bound"][0]) / 2,
        bound_by=per_d[48]["bound"][1], library_ms=mean("library_ms"),
        library_call_ms=mean("library_call_ms"), per_width=per_d)
    return rec


# --- phases 4 and 5 -----------------------------------------------------------

def reset_counts() -> None:
    phys_cuda.launches = 0
    lstm_cuda.launches = 0


def read_counts() -> tuple[int, int]:
    torch.cuda.synchronize()
    return phys_cuda.launches, lstm_cuda.launches


def check_counts(counts, steps: int, what: str) -> None:
    want = (8 * steps, 4 * steps)
    if counts != want:
        raise RuntimeError(f"{what}: launches (phys, lstm) {counts}, expected {want}")
    log(f"[{what}] launches: phys_substep {counts[0]}, lstm_cell {counts[1]} "
        f"(8 and 4 per control step)")


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
    two kernels by name."""
    out = {"phys_substep": 0.0, "lstm_cell": 0.0, "all": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        out["all"] += ms
        for k in ("phys_substep", "lstm_cell"):
            if f"{k}_kernel" in e.name:
                out[k] += ms
    return out


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

    # PyTorch ops the host issues a control step: a 2-step rollout less a 1-step one
    calls = []
    for n in (1, 2):
        with OpCounter() as oc:
            ev.policy_rollout(cfg, params, cmds, gen, n, device=DEVICE)
        calls.append(oc.calls)
    ops_per_step = calls[1] - calls[0]

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
            "torch_ops_per_step": ops_per_step,
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
    full = phase_full_width(params, {k: v["ms"] for k, v in kern.items()})

    sources = {"phys_substep": ("high_speed_quadrupedal_locomotion_by_irrl_torch/csrc/phys_substep.cu",
                                "high_speed_quadrupedal_locomotion_by_irrl_tpu/ops/phys_pallas.py:71"),
               "lstm_cell": ("high_speed_quadrupedal_locomotion_by_irrl_torch/csrc/lstm_cell.cu",
                             "high_speed_quadrupedal_locomotion_by_irrl_tpu/ops/lstm_pallas.py:26")}
    kernels = []
    for name, (src, repl) in sources.items():
        k = kern[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": serving["launches"][name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        "launches_full_width": full["launches"][name],
                        "call_ms": k["call_ms"], "plain_call_ms": k["plain_call_ms"],
                        "library_call_ms": k.get("library_call_ms")})
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
