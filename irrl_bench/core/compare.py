"""The numbers that decide ``correct``, and the precision switch of the control.

Every number is a gap between what the program produced and what the plain
reference computes from the same inputs, as a share of a scale the reference
sets, so that it reads alike at every batch size. The control runs the
reference again with TF32 products (the nearest precision below the float32
with TF32 off that the configurations state) and reads the same numbers
against the float32 reference.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

from irrl_bench.reference import numerics


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's products in float32 with TF32 off, or (the control)
    with their operands rounded to TF32 (``reference/numerics.py``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with numerics.tf32(tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(x.double() ** 2)))


def widest(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """The widest gap of ``got`` from ``want``, over ``scale``. NaN where any
    value is not finite (a comparison it can never pass)."""
    if not bool(torch.isfinite(got).all()):
        return float("nan")
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-30)


# the state's columns by quantity: position, orientation, joint angles, linear,
# angular and joint velocities
STATE_GROUPS = ((0, 3), (3, 7), (7, 19), (19, 22), (22, 25), (25, 37))


def state_gaps(got: torch.Tensor, want: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """(B,) gap of each env's (37,) state [gc, gv] after a step: the widest
    over its columns, each quantity's columns over the RMS (over the batch and
    the quantity's columns) of their change during the step. A step that
    leaves the state unchanged reads, at its widest, the largest change over
    its RMS: 1 or more. An env whose state is not finite reads infinity."""
    gap = (got.double() - want.double()).abs()
    change = (want.double() - before.double()) ** 2
    out = torch.zeros(got.shape[0], dtype=torch.float64, device=got.device)
    for lo, hi in STATE_GROUPS:
        scale = float(torch.sqrt(change[:, lo:hi].mean()))
        out = torch.maximum(out, gap[:, lo:hi].amax(-1) / max(scale, 1e-30))
    return torch.where(torch.isfinite(got).all(-1) & torch.isfinite(out), out, float("inf"))


def finite_or_none(x):
    """A number for the result's JSON line: None where it is not finite."""
    return x if not isinstance(x, float) or math.isfinite(x) else None


def leaf_gaps(got: dict, want: dict, skip: set = frozenset()) -> dict:
    """Each leaf's gap between the norms of ``got[name]`` and ``want[name]``,
    over the larger of the reference leaf's norm and the median leaf's (NaN
    where ``got`` is not finite); the leaves in ``skip`` left out."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    median = statistics.median(norms[k] for k in want if k not in skip)
    out = {}
    for k in want:
        if k in skip:
            continue
        g = got[k]
        out[k] = (abs(float(torch.linalg.vector_norm(g.double())) - norms[k])
                  / max(norms[k], median) if bool(torch.isfinite(g).all()) else float("nan"))
    return out


def leaf_gap(got: dict, want: dict, skip: set = frozenset()) -> float:
    """The worst of :func:`leaf_gaps`."""
    return worst(*leaf_gaps(got, want, skip).values())


def worst(*values: float) -> float:
    """The largest of ``values``; NaN if any is NaN."""
    return float("nan") if any(v != v for v in values) else max(values)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number compared beside its limit: the numbers
    ``limits`` names, each a finite number within its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
