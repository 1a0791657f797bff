"""Time the LSTM sequence kernels' tiles on the card.

    python3 scripts/lstm_seq_tiles.py [--out runs/lstm_seq_tiles.json]

Builds ``csrc/lstm_cell.cu`` once for each tile (rows a thread x row groups
a block: 16 rows of 4 a thread, 16 of 2, 8 of 2), set for both sequence
kernels through its ``-DSEQ_*`` macros, into ``build/lstm_seq_tiles/``. Each
build drives one layer of both towers at the training epochs' shape
(T = 750, B = 1024, n = 48; layer 1: d = 35 without an input gradient,
layer 2: d = 48 with one) through ``ops.lstm_cuda.lstm_layer_sequence`` and
its backward, in the order A B C C B A twice, and reports each kernel's
median device time (torch.profiler) a launch beside ptxas' registers and
spills. The tiles must give the same bits: each (row, unit) sums in the
same order whatever the tile. The source's defaults hold the fastest of
each kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm  # noqa: E402
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import _build, lstm_cuda  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "lstm_seq_tiles")
T, B, N = 750, 1024, 48
TILES = {"16x4": (4, 4), "16x2": (2, 8), "8x2": (2, 4)}   # rows a block x a thread: (kR, kG)
LAYERS = ((35, False), (48, True))
KERNELS = ("lstm_seq_train_kernel", "lstm_seq_bwd_kernel")


def build() -> dict:
    """nvcc the source once a tile, all at once; -> {tag: (library, ptxas
    lines of the sequence kernels)}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src, procs = os.path.join(_build.CSRC, "lstm_cell.cu"), {}
    for tag, (rows, groups) in TILES.items():
        so = os.path.join(OUT_DIR, f"liblstm_cell_{tag}.so")
        defs = [f"-DSEQ_{k}_{w}={v}" for k in ("TRAIN", "BWD")
                for w, v in (("ROWS", rows), ("GROUPS", groups))]
        procs[tag] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o", so, src],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on tile {tag}:\n{log}")
        lines = log.splitlines()
        ptx = [f"{ln.split('lstm_seq_')[-1].split('EEEv')[0]}: {lines[i + 1].strip()}; "
               f"{lines[i + 2].strip()}" for i, ln in enumerate(lines[:-2])
               if "Function properties" in ln and "lstm_seq_" in ln]
        out[tag] = (ctypes.CDLL(so), ptx)
    return out


def use(lib) -> None:
    """Make ``lib`` the loaded lstm_cell library that ops.lstm_cuda launches from."""
    _build._libs["lstm_cell"] = lib
    lstm_cuda._fns.cache_clear()


def layer(d: int, need_dx: bool):
    g = torch.Generator(device="cuda").manual_seed(d)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device="cuda")  # noqa: E731
    ws = [lstm.LSTMWeights(r(d, 4 * N, scale=0.2).requires_grad_(), r(N, 4 * N, scale=0.2),
                           r(4 * N, scale=0.1)) for _ in range(2)]
    xs = [r(T, B, d).requires_grad_(need_dx) for _ in range(2)]
    state = r(B, 4 * N)
    states = [(state[:, 2 * N * i:2 * N * i + N], state[:, 2 * N * i + N:2 * N * (i + 1)])
              for i in range(2)]
    mask = (torch.rand(T, B, generator=g, device="cuda") < 0.02).float()
    up = [r(T, B, N) for _ in range(2)]
    leaves = [w.wx for w in ws] + (xs if need_dx else [])

    def forward():
        return lstm_cuda.lstm_layer_sequence(ws, xs, mask, states)

    def backward(out):
        return torch.autograd.grad(sum((h * u).sum() for (_, h), u in zip(out, up)), leaves)
    return forward, backward


def kernel_ms(run) -> dict:
    """Median device time (ms) of each sequence kernel's launches in 5 runs."""
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    got = {k: [e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and k in e.name] for k in KERNELS}
    if not all(got.values()):
        raise RuntimeError(f"the profiler saw no launch of {[k for k, v in got.items() if not v]}")
    return {k: statistics.median(v) for k, v in got.items()}


def tiles() -> dict:
    built = build()
    res = {"ptxas": {tag: ptx for tag, (_, ptx) in built.items()}, "layers": {}}
    for tag, ptx in res["ptxas"].items():
        print(f"ptxas {tag}: {ptx}", flush=True)
    order = list(TILES) + list(reversed(TILES))
    for d, need_dx in LAYERS:
        forward, backward = layer(d, need_dx)
        run = lambda: backward(forward())  # noqa: E731
        turns = {tag: {k: [] for k in KERNELS} for tag in TILES}
        bits = {}
        for tag in order * 2:
            use(built[tag][0])
            for k, ms in kernel_ms(run).items():
                turns[tag][k].append(ms)
            if tag not in bits:
                out = forward()
                bits[tag] = [t for pair in out for t in pair] + list(backward(out))
        same = {tag: all(torch.equal(a, b) for a, b in zip(bits[order[0]], v))
                for tag, v in bits.items()}
        key = f"d={d}, {'dx' if need_dx else 'no dx'}"
        res["layers"][key] = {"turns_ms": turns, "same_bits": same, "median_ms": {
            tag: {k: statistics.median(v) for k, v in t.items()} for tag, t in turns.items()}}
        for tag, t in res["layers"][key]["median_ms"].items():
            print(f"{key} tile {tag}: forward {t[KERNELS[0]]:.4f} ms, backward {t[KERNELS[1]]:.4f} "
                  f"ms a launch (turns: forward "
                  + " ".join(f"{x:.4f}" for x in turns[tag][KERNELS[0]]) + "; backward "
                  + " ".join(f"{x:.4f}" for x in turns[tag][KERNELS[1]])
                  + f"); the same bits as {order[0]}: {same[tag]}", flush=True)
        if not all(same.values()):
            raise RuntimeError(f"{key}: the tiles gave different bits: {same}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("runs", "lstm_seq_tiles.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    res = {"card": card, "T": T, "B": B, "tiles": tiles()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
