"""What the per-layer metrics read from a traced run's observations.

``obs`` holds the window (its seconds, units and work), the entry's own
readings of the window (``layers``), the synchronized timers (``sites``), the
profiled unit's device events (``profile``), the program's op counts
(``ops``) and the frozen work of a unit (``work``). A reader that finds
nothing to read returns None, and its metric is left out of the line.
"""

from __future__ import annotations

import statistics

from irrl_bench.counts import peaks


def kernel_seconds(obs: dict, name: str) -> tuple[float, int] | None:
    """Device seconds and launches of the profiled unit's kernels whose
    (mangled) name holds ``name``."""
    prof = obs.get("profile")
    if not prof:
        return None
    durs = [(e - s) / 1e9 for n, s, e in prof["events"] if name in n]
    return (sum(durs), len(durs)) if durs else None


def roofline(obs: dict, name: str, cycle) -> float | None:
    """The kernels' share of their bound: the least time the launches the
    profiled unit made could take, over the time they took, in %. ``cycle``
    lists the (operations, bytes) of the launches a step makes in order (a
    kernel launched once a layer has one entry a layer)."""
    k = kernel_seconds(obs, name)
    if not cycle or k is None or k[0] <= 0.0 or k[1] % len(cycle):
        return None
    bound = sum(peaks.bound_s(ops, nbytes) for ops, nbytes in cycle)
    return 100.0 * (k[1] // len(cycle)) * bound / k[0]


def idle_share(obs: dict) -> float | None:
    prof = obs.get("profile")
    if not prof or prof["window_s"] <= 0.0 or prof["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu(obs: dict) -> float | None:
    """The frozen operations of the window's units over its time at the
    float32 peak, in %."""
    w, ops = obs["window"], obs["work"].get("unit_ops")
    if not ops or w["seconds"] <= 0.0:
        return None
    return 100.0 * ops * w["units"] / (w["seconds"] * peaks.F32_FLOP_PER_S)


def site_ms_per_call(obs: dict, site: str) -> float | None:
    s = obs["sites"].get(site)
    if not s or not s["calls"]:
        return None
    return 1e3 * s["seconds"] / s["calls"]


def mean(values) -> float | None:
    values = list(values)
    return statistics.fmean(values) if values else None
