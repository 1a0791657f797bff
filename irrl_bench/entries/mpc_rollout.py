"""A fleet of robots under the convex SRB trot-MPC: ``mpc/runtime.mpc_rollout``
under ``mpc/runtime.high_speed_setup`` (Convert2Torque stance torques into
the physics kernel), as ``cli/mpc.py --engine srb`` runs a schedule batch.

A unit is one rollout of a fresh fleet: every robot at its own command drawn
from the seed, from the stand pose. Set-up runs a rollout of
``WARM_UP_STEPS`` steps: every control step runs the same ops at the same
shapes, so a few build them all. In the window's first rollout the
loop's calls are recorded at control steps drawn from the seed:
``srb.make_problem`` (the loop's state to a problem), ``srb.solve`` (its
force plans and costs), ``srb.grf_to_torque`` and the physics kernel with its
torque inputs. Once the window has closed the plain reference
(``reference/srb.py``, ``reference/physics.py``) takes each recorded call
from the same inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import runtime, srb

from irrl_bench.core import compare, measure, physics_check, port, traffic
from irrl_bench.counts import phys as phys_counts
from irrl_bench.counts import srb as srb_counts
from irrl_bench.reference import srb as ref_srb

WARM_UP_STEPS = 4


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _keep_problem(a, kw, out):
    _, gc, gv, command, t0 = a[:5]
    return {"in": [_clone(x) for x in (gc, gv, command, t0)],
            "out": [_clone(x) for x in out]}


def _keep_solve(a, kw, out):
    return {"prob": [_clone(x) for x in a[2]], "forces": _clone(out.forces),
            "cost": _clone(out.cost)}


def _keep_torque(a, kw, out):
    _, gc, f, sm, stance_pd, swing_pd = a[:6]
    return {"in": [_clone(x) for x in (gc, f, sm)], "pd": (stance_pd, swing_pd),
            "out": [_clone(x) for x in out]}


class Session:
    def __init__(self, ctx):
        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        self.B, self.T = tr["num_envs"], tr["n_steps"]
        base = port.env_config({"env": cfg["env"], "contact": {}}, "env", self.B)
        self.env_cfg, self.scfg, self.kwargs = runtime.high_speed_setup(base)
        self._check_config(cfg)
        picks = traffic.picks(ctx.seed, self.T, tr["checked_steps"])
        self.recorders = [physics_check.KernelRecorder(picks),
                          measure.Recorder(srb, "make_problem", picks, _keep_problem),
                          measure.Recorder(srb, "solve", picks, _keep_solve),
                          measure.Recorder(srb, "grf_to_torque", picks, _keep_torque)]
        self.units = 0
        self.step_walls: list[float] = []
        self._rollout(warm_up=True, n_steps=WARM_UP_STEPS)

    def _check_config(self, cfg: dict) -> None:
        """The configuration file states what the port's high-speed setup runs."""
        have = {f.name: getattr(self.scfg, f.name) for f in dataclasses.fields(self.scfg)}
        want = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["srb"].items()}
        contact = {k: getattr(self.env_cfg, k) for k in cfg["contact"]}
        if have != want or self.kwargs != cfg["runtime"] or contact != cfg["contact"]:
            raise ValueError(f"the configuration file does not state the port's setup: "
                             f"{have} {self.kwargs} {contact}")

    def _rollout(self, warm_up: bool = False, n_steps: int | None = None) -> None:
        seq = np.random.SeedSequence([self.ctx.seed, self.units, int(warm_up)])
        gen = torch.Generator(device=self.ctx.device).manual_seed(
            int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        cmd = traffic.commands(self.ctx.traffic, self.ctx.seed, self.units, self.ctx.device)
        log = runtime.mpc_rollout(self.env_cfg, self.scfg, cmd, gen, n_steps or self.T,
                                  device=self.ctx.device, **self.kwargs)
        del log

    def _step_clock(self):
        """Synchronized host times at each control step's start (its
        ``make_problem``) and at the rollout's end."""
        marks = []

        def make(orig):
            def run(*a, **kw):
                marks.append(measure.now())
                return orig(*a, **kw)
            return run
        return marks, measure.Patch(srb, "make_problem", make)

    def unit(self) -> float:
        first = self.units == 0
        marks, clock = self._step_clock()
        with contextlib.ExitStack() as stack:
            if first:
                stack.enter_context(self.ctx.faults(self))
                for r in self.recorders:
                    stack.enter_context(r)
            if self.ctx.trace:
                stack.enter_context(clock)
            self._rollout()
        if self.ctx.trace:
            marks.append(measure.now())
            self.step_walls += [b - a for a, b in zip(marks[:-1], marks[1:])]
        self.units += 1
        return float(self.B * self.T)

    def layer_readings(self) -> dict:
        return {"step_walls": list(self.step_walls)}

    def sites(self) -> dict:
        return {"solve": (srb, "solve"), "env_step": (bp, "step_batch")}

    def op_counts(self) -> dict:
        k = 8
        ops = lambda n: measure.count_calls(lambda: self._rollout(n_steps=n))  # noqa: E731
        return {"control_step": (ops(2 * k) - ops(k)) / k}

    def work(self) -> dict:
        env_ops = phys_counts.ops_per_env(self.env_cfg.substeps, convert2torque=True,
                                          motor_dynamics=self.env_cfg.motor_dynamics)
        solve = srb_counts.riccati_ops() * self.scfg.horizon
        return {"unit_ops": self.T * self.B * (solve + env_ops),
                "phys_kernel": [(self.B * env_ops,
                                 self.B * phys_counts.bytes_per_env(convert2torque=True))]}

    def release(self) -> None:
        pass

    def numbers(self, control: bool = False) -> dict:
        prog = self._numbers(False)
        if not control:
            return prog
        return {"program": prog, "control": self._numbers(True)}

    def _numbers(self, control: bool) -> dict:
        dev, cfg = self.ctx.device, self.ctx.config
        phys, problems, solves, torques = self.recorders
        out = phys.numbers(cfg["env"], cfg["contact"], dev, control=control)
        s = ref_srb.settings(cfg["env"], cfg["srb"])
        mass, inertia = ref_srb.body_constants(dev)
        gaps = {"problem_gap": 0.0, "force_gap": 0.0, "cost_gap": 0.0, "torque_gap": 0.0}

        def run(fn, got):
            """(what is judged, the float32 reference): the program's
            recorded output, or the TF32 reference's in its place."""
            with compare.precision(False), torch.no_grad():
                want = fn()
            if control:
                with compare.precision(True), torch.no_grad():
                    got = fn()
            return got, want

        def add(name, got, want):
            gaps[name] = compare.worst(gaps[name], compare.widest(got, want, compare.rms(want)))

        for r in problems.kept.values():
            got, want = run(lambda: ref_srb.make_problem(*r["in"]), r["out"])
            add("problem_gap", torch.cat([got[0], got[3][:, None], got[4]], -1),
                torch.cat([want[0], want[3][:, None], want[4]], -1))
        for r in solves.kept.values():
            prob = ref_srb.Problem(*r["prob"])
            got, want = run(lambda: ref_srb.solve(s, prob, mass, inertia),
                            ref_srb.Solution(r["forces"], r["cost"]))
            add("force_gap", got.forces, want.forces)
            add("cost_gap", got.cost, want.cost)
        for r in torques.kept.values():
            got, want = run(lambda: ref_srb.grf_to_torque(*r["in"], *r["pd"]), r["out"])
            add("torque_gap", got[0], want[0])
        if not (problems.kept and solves.kept and torques.kept):
            gaps = dict.fromkeys(gaps, float("nan"))
        out.update(gaps)
        return out


def setup(ctx) -> Session:
    return Session(ctx)


def faults(session, name: str):
    if name == "unchanged":
        return physics_check.unchanged_state()
    if name == "minority":
        return physics_check.minority_unstepped()
    if name in ("half", "altered"):
        def make(orig):
            def run(*a, **kw):
                res = orig(*a, **kw)
                f = res.forces.clone()
                if name == "half":    # the second half of the fleet's plans left out
                    f[f.shape[0] // 2:] = 0.0
                else:                 # one robot's plan altered where the solve makes it
                    f[0, :, :, 2] += 1.0
                return res._replace(forces=f)
            return run
        return measure.Patch(srb, "solve", make)
    raise ValueError(f"unknown fault {name!r}")
