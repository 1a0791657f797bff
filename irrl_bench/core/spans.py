"""The program's host spans laid over the profiled unit's device events.

While a torch.profiler window is open the port records host spans and
counters (``utils/profiling``: ``(name, parent, step, t0_ns, t1_ns)`` in
Unix-epoch nanoseconds, on the line the profiler maps its device events onto).
:func:`recorded` takes them from the program once, after the profiled unit,
and keeps them in ``obs["spans"]``; without a profile, or with a program that
records none, it gives None and every reader built on it returns None.

:func:`attribute` splits the device's idle time over the host: idle is the
complement of the busy union of the device events within a root span (the
profiled update or rollout), and each idle stretch goes to the innermost span
the host had open during it, by overlap. What falls in the root's own time is
unattributed. In the MPC's traced unit the benchmark's step clock
synchronizes before each control step's ``make_problem``; that wait is a line
of its own (``STEP_CLOCK``), carved out of ``mpc.step`` as the stretch from the
step's start to its ``srb.make_problem`` span.
"""

from __future__ import annotations

import statistics

STEP_CLOCK = "the benchmark's step clock"
# (span, its child): the stretch of the span before the child is the step clock's
CLOCKS = {"mpc.rollout": ("mpc.step", "srb.make_problem")}

NAME, PARENT, STEP, T0, T1 = range(5)


def recorded(obs: dict) -> dict | None:
    """``{"spans": [...], "counts": [...]}`` of the profiled unit, or None."""
    if "spans" not in obs:
        obs["spans"] = _take() if obs.get("profile") else None
    return obs["spans"]


def _take() -> dict | None:
    try:
        from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import profiling
    except ImportError:
        return None
    take = getattr(profiling, "take", None)
    if take is None:
        return None
    rec = take()
    spans = [tuple(s) for s in rec.spans]
    return {"spans": spans, "counts": [tuple(c) for c in rec.counts]} if spans else None


def busy_intervals(events) -> list[tuple[int, int]]:
    """The union of the device events' [start, end) as sorted disjoint intervals."""
    out: list[list[int]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _with_clock(spans: list, root: str) -> list:
    """``spans`` and, under each span of ``CLOCKS[root]``, the step clock's
    stretch as a span of its own."""
    if root not in CLOCKS:
        return spans
    outer, inner = CLOCKS[root]
    first: dict[int, int] = {}
    for i, s in enumerate(spans):
        p = s[PARENT]
        if s[NAME] == inner and p >= 0 and spans[p][NAME] == outer and p not in first:
            first[p] = i
    extra = [(STEP_CLOCK, p, spans[p][STEP], spans[p][T0], spans[i][T0])
             for p, i in sorted(first.items())]
    return spans + extra


def _segments(spans: list, children: dict, node: int):
    """(start, end, index of the innermost span) over ``node``'s interval, in order."""
    t = spans[node][T0]
    for c in sorted(children.get(node, ()), key=lambda i: spans[i][T0]):
        if spans[c][T0] > t:
            yield t, spans[c][T0], node
        yield from _segments(spans, children, c)
        t = max(t, spans[c][T1])
    if spans[node][T1] > t:
        yield t, spans[node][T1], node


def attribute(rec: dict, events, root: str) -> dict | None:
    """The host's spans under each ``root`` span against the device's idle time.

    Returns ``wall_s`` (the roots' time), ``idle_s`` (their device-idle time),
    ``steps`` (distinct control steps), ``spans`` (per name: calls, host ms a
    step in total and in the span's own time, idle seconds as the innermost
    span), ``unattributed_share`` (the idle in the roots' own time over all
    the idle) and ``under(name)``: the idle seconds below every span of that
    name."""
    spans = _with_clock([s for s in rec["spans"] if s[T1] is not None], root)
    roots = [i for i, s in enumerate(spans) if s[NAME] == root]
    if not roots:
        return None
    children: dict[int, list] = {}
    for i, s in enumerate(spans):
        if s[PARENT] >= 0:
            children.setdefault(s[PARENT], []).append(i)
    busy = busy_intervals(events)
    idle_at: dict[int, int] = {}
    wall = idle = 0
    for r in roots:
        r0, r1 = spans[r][T0], spans[r][T1]
        wall += r1 - r0
        gaps, t = [], r0
        for s, e in busy:
            if e <= r0 or s >= r1:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < r1:
            gaps.append((t, r1))
        idle += sum(e - s for s, e in gaps)
        g = 0
        for a, b, i in _segments(spans, children, r):
            while g < len(gaps) and gaps[g][1] <= a:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < b:
                over = min(b, gaps[k][1]) - max(a, gaps[k][0])
                if over > 0:
                    idle_at[i] = idle_at.get(i, 0) + over
                k += 1
    inside = set()
    stack = list(roots)
    while stack:
        i = stack.pop()
        inside.add(i)
        stack.extend(children.get(i, ()))
    steps = {spans[i][STEP] for i in inside if spans[i][STEP] is not None}
    n = max(len(steps), 1)
    per: dict[str, dict] = {}
    for i in sorted(inside):
        s = spans[i]
        d = s[T1] - s[T0]
        own = d - sum(spans[c][T1] - spans[c][T0] for c in children.get(i, ()))
        row = per.setdefault(s[NAME], {"calls": 0, "host_ms_per_step": 0.0,
                                       "self_ms_per_step": 0.0, "idle_s": 0.0})
        row["calls"] += 1
        row["host_ms_per_step"] += d / 1e6 / n
        row["self_ms_per_step"] += own / 1e6 / n
        row["idle_s"] += idle_at.get(i, 0) / 1e9

    def under(name: str) -> float:
        return sum(v for i, v in idle_at.items() if name in _path(spans, i)) / 1e9

    return {"wall_s": wall / 1e9, "idle_s": idle / 1e9, "steps": len(steps), "spans": per,
            "under": under,
            "unattributed_share": sum(idle_at.get(r, 0) for r in roots) / idle if idle else 0.0}


def _path(spans: list, i: int) -> list[str]:
    out = []
    while i >= 0:
        out.append(spans[i][NAME])
        i = spans[i][PARENT]
    return out[::-1]


def analysis(obs: dict, root: str) -> dict | None:
    """:func:`attribute` of the profiled unit, computed once a run."""
    rec = recorded(obs)
    if rec is None:
        return None
    cache = obs.setdefault("span_analysis", {})
    if root not in cache:
        cache[root] = attribute(rec, obs["profile"]["events"], root)
    return cache[root]


def host_ms_per_step(obs: dict, root: str, name: str) -> float | None:
    a = analysis(obs, root)
    if a is None or not a["steps"] or name not in a["spans"]:
        return None
    return a["spans"][name]["host_ms_per_step"]


def idle_share_under(obs: dict, root: str, name: str) -> float | None:
    """The device-idle time below the spans named ``name``, over the roots' wall, in %."""
    a = analysis(obs, root)
    if a is None or name not in a["spans"] or a["wall_s"] <= 0.0:
        return None
    return 100.0 * a["under"](name) / a["wall_s"]


def count_per_step(obs: dict, root: str, counter: str) -> float | None:
    """The counter's sum over the control steps, over their number."""
    rec, a = recorded(obs), analysis(obs, root)
    if rec is None or a is None or not a["steps"]:
        return None
    total = sum(c[3] for c in rec["counts"] if c[0] == counter and c[2] is not None)
    return total / a["steps"]


def host_durations_ms(obs: dict, root: str, name: str) -> list[float] | None:
    """Host milliseconds of each span named ``name``, less its step clock."""
    rec = recorded(obs)
    if rec is None:
        return None
    spans = _with_clock([s for s in rec["spans"] if s[T1] is not None], root)
    clock = {s[PARENT]: s[T1] - s[T0] for s in spans if s[NAME] == STEP_CLOCK}
    return [(s[T1] - s[T0] - clock.get(i, 0)) / 1e6 for i, s in enumerate(spans)
            if s[NAME] == name]


def p95(values) -> float | None:
    """The 95th percentile of at least 200 values, as ``mpc_step_ms_p95`` takes it."""
    if values is None or len(values) < 200:
        return None
    return statistics.quantiles(values, n=20)[-1]
