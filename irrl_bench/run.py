"""Runs one cell of the port's benchmark and prints its result as one JSON line.

    python3 irrl_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``workloads/<cell>.json`` (its
configuration, its entry, its traffic and the limits of its comparison),
``configs/<config>.json``, ``entries/<entry>.py`` (what set-up builds and what
one unit of the window runs) and, in a traced run, ``metrics/<metric>.py``
for each per-layer metric ``BENCHMARK.json`` gives the cell.

A run builds its state on the device from ``--seed`` and warms up its shapes
(set-up, timed from the process's start), then runs whole units back to back,
starting one only while less than ``--seconds`` have passed; a rate is all
their work over all their time. With ``--trace 1`` the window runs under
synchronized timers, one more unit runs under the profiler, and the program's
PyTorch ops are counted; the line then carries the per-layer metrics.
Once the window has closed and the program's state is freed, the entry's
comparison with the plain reference decides ``correct``; each number and its
limit end the line and standard error.

Options for the benchmark's own tests and measurements, which the benchmark's
runs do not use: ``--control 1`` prints the TF32 reference's readings beside
the program's; ``--fault <name>`` plants one of the entry's faults; ``--device
cpu`` with ``--override '{"traffic": {...}, "workload": {...}}'`` runs a
cut-down cell on the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that must not be loaded, compared by their top-level name
BANNED = ("jax", "jaxlib", "flax", "high_speed_quadrupedal_locomotion_by_irrl_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default=None, help="JSON of keys merged into the cell's files")
    return p.parse_args(argv)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """``<kind>/<name>.py`` of the benchmark's folder, by file (a name may
    hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"irrl_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def cell_metrics(bench: dict, cell: str, reports: set) -> tuple[list, list]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` gives ``cell``."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    missing = names - reports
    if missing:
        raise ValueError(f"cell {cell} does not measure {sorted(missing)}")
    return e2e, layer


class Context:
    """What an entry's set-up gets: the cell, its traffic, its configuration,
    the seed and the device; ``faults(session)`` plants the fault asked for, if any."""

    def __init__(self, args, workload: dict, traffic: dict, config: dict, entry, device):
        self.workload, self.traffic, self.config, self.entry = workload, traffic, config, entry
        self.seed, self.device, self.root = args.seed, device, ROOT
        self.fault, self.trace = args.fault, bool(args.trace)
        self.ref_block = workload.get("reference_block", 2048)

    def faults(self, session):
        if self.fault is None:
            return contextlib.nullcontext()
        return self.entry.faults(session, self.fault)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    workload = load_json(HERE, "workloads", args.workload + ".json")
    traffic = load_json(HERE, "traffic", workload["traffic"] + ".json")
    if args.override:
        over = json.loads(args.override)
        workload = {**workload, **over.get("workload", {})}
        traffic = {**traffic, **over.get("traffic", {})}
    if args.device == "cuda":
        need = int(workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"irrl_bench: the cell needs {need} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
    device = torch.device(args.device)
    bench = load_json(ROOT, "BENCHMARK.json")
    config = load_json(HERE, "configs", workload["config"] + ".json")
    entry = load_module("entries", workload["entry"])
    rate_name = workload["rate_metric"]
    e2e, layer = cell_metrics(bench, args.workload, {"setup_s", rate_name})

    from irrl_bench.core import compare, measure

    cuda = device.type == "cuda"
    if cuda:
        from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build
        built = _build.build()   # the kernels' nvcc builds: only a checkout's first run makes them
        print(f"irrl_bench: nvcc builds {built or 'none (built before)'}", file=sys.stderr)
        torch.cuda.reset_peak_memory_stats()
    session = entry.setup(Context(args, workload, traffic, config, entry, device))
    t0 = measure.now()
    setup_s = t0 - T_START

    timers = measure.SyncedTimers(session.sites()) if args.trace else contextlib.nullcontext()
    units, work, ends = 0, 0.0, []
    with timers:
        t0 = measure.now()
        while True:
            work += session.unit()
            units += 1
            window_s = measure.now() - t0
            ends.append(window_s)
            if window_s >= args.seconds:
                break
    print(f"irrl_bench: set-up {setup_s:.3f} s; window {units} units, seconds each "
          f"{[round(b - a, 3) for a, b in zip([0.0] + ends, ends)]}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                     "count": int(workload["chips"]), "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if args.trace:
        obs = {"window": {"seconds": window_s, "units": units, "work": work},
               "layers": session.layer_readings(), "work": session.work(),
               "sites": {k: {"seconds": timers.seconds[k], "calls": timers.calls[k]}
                         for k in timers.sites}}
        obs["profile"] = measure.profile(session.unit) if cuda else None
        obs["ops"] = session.op_counts()
        if obs["profile"] is not None:
            result_device["busy_s"] = obs["profile"]["busy_s"]
            result_device["window_s"] = obs["profile"]["window_s"]
            breakdown = measure.breakdown(obs["profile"]["events"])
        for m in layer:
            value = load_module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        have = {"setup_s": setup_s, rate_name: work / window_s}
        metrics = {m["name"]: {"value": have[m["name"]], "unit": m["unit"]} for m in e2e}

    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = session.numbers(control=bool(args.control))
    program = numbers["program"] if args.control else numbers
    if args.control or args.fault:
        for name, value in program.items():
            ctl = f" control {numbers['control'].get(name)}" if args.control else ""
            print(f"reading {name}: program {value}{ctl}", file=sys.stderr)
    correct, checks = compare.judge(program, workload["limits"])
    if args.control:
        checks = {k: {**v, "control": numbers["control"].get(k)} for k, v in checks.items()}

    found = banned_modules()
    if found:
        print(f"irrl_bench: modules that must not be loaded are loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": units, "failed": 0, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {f: compare.finite_or_none(x) for f, x in c.items()}
                        for k, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.exit(code)
