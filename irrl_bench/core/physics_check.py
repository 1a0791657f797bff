"""The physics kernel's calls, recorded where they happen and held to the
plain reference physics.

``phys_cuda.control_step`` is the port's one entry into the physics kernel
(``envs/blackpanther.step_batch`` looks it up at every call). The recorder
keeps, at the calls drawn from the seed, the per-env robot parameters, the
state, the PD targets and the other inputs the kernel was given, and the
state it returned. The reference then takes the same control step from the
same inputs. Between calls the program's state is the program's: the
reference follows it step by step, as the physics is chaotic over many
steps (a 1e-6 m nudge moves a loop's outcome).
"""

from __future__ import annotations

import inspect
import sys

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_cuda

from irrl_bench.core import compare, measure
from irrl_bench.reference import physics as ref_phys

_SIG = inspect.signature(phys_cuda.control_step)


def _robot(P) -> ref_phys.Robot:
    c = lambda x, *perm: x.permute(*perm).contiguous().clone()  # noqa: E731
    return ref_phys.Robot(mass=c(P.mass, 1, 0), com=c(P.com, 2, 0, 1),
                          inertia=c(P.inertia, 3, 0, 1, 2), joint_origin=c(P.joint_origin, 2, 0, 1),
                          friction=P.friction.clone(), kn=P.kn.clone(), dn=P.dn.clone())


def _keep(a, kw, out) -> dict:
    args = _SIG.bind(*a, **kw).arguments
    rows = lambda x: None if x is None else x.T.contiguous().clone()  # noqa: E731
    if args.get("terrain") is not None:
        raise ValueError("the reference physics is of flat ground")
    return {"robot": _robot(args["P"]), "gc": rows(args["gcT"]), "gv": rows(args["gvT"]),
            "ptarget": rows(args["ptargetT"]), "tnl": rows(args["torque_norm_lastT"]),
            "wrench": rows(args["base_wrenchT"]), "tau_ff": rows(args.get("tau_ffT")),
            "pd_scale": rows(args.get("pd_scaleT")), "gc_out": rows(out[0]),
            "gv_out": rows(out[1])}


class KernelRecorder(measure.Recorder):
    """Records the physics kernel's calls whose index is in ``picks``."""

    def __init__(self, picks):
        super().__init__(phys_cuda, "control_step", picks, _keep)

    def numbers(self, env: dict, contact: dict, device, control: bool = False) -> dict:
        """The per-env gaps of the state after the recorded steps from the
        reference's (``compare.state_gaps``), all recorded steps together:
        ``phys_gap`` their widest, ``phys_gap_p50`` their median and
        ``phys_gap_p999`` their 99.9th percentile, which any fault in more
        than a thousandth of the env-steps reaches (an env whose state is
        not finite reads infinity); with ``control`` the TF32 reference's in
        the program's place."""
        if not self.kept:
            return dict.fromkeys(("phys_gap", "phys_gap_p50", "phys_gap_p999"), float("nan"))
        s = ref_phys.settings(env, contact, device)
        gaps = []
        for rec in self.kept.values():
            def run(r=rec):
                gc, gv, _ = ref_phys.control_step(r["robot"], s, r["gc"], r["gv"], r["ptarget"],
                                                  r["tnl"], r["wrench"], r["tau_ff"],
                                                  r["pd_scale"])
                return torch.cat([gc, gv], dim=-1)
            with compare.precision(False):
                want = run()
            if control:
                with compare.precision(True):
                    got = run()
            else:
                got = torch.cat([rec["gc_out"], rec["gv_out"]], dim=-1)
            gaps.append(compare.state_gaps(got, want, torch.cat([rec["gc"], rec["gv"]], dim=-1)))
        gaps = torch.sort(torch.cat(gaps)).values
        q = [float(gaps[min(int(f * gaps.numel()), gaps.numel() - 1)])
             for f in (0.5, 0.9, 0.99, 0.999)]
        print(f"irrl_bench: physics gaps over {gaps.numel()} env-steps{' (control)' * control}: "
              f"p50 {q[0]:.3g} p90 {q[1]:.3g} p99 {q[2]:.3g} p99.9 {q[3]:.3g} "
              f"max {float(gaps[-1]):.3g}", file=sys.stderr)
        return {"phys_gap": float(gaps[-1]), "phys_gap_p50": q[0], "phys_gap_p999": q[3]}


# --- faults the comparison must catch ------------------------------------------

def _wrap_kernel(change):
    return measure.Patch(phys_cuda, "control_step",
                         lambda orig: lambda *a, **kw: change(orig, a, kw))


def alter_output():
    """One env's base velocity altered by 0.1 m/s where the kernel makes it."""
    def change(orig, a, kw):
        out = orig(*a, **kw)
        out[1][0, 0] += 0.1
        return out
    return _wrap_kernel(change)


def unchanged_state():
    """The kernel hands back the state it was given."""
    def change(orig, a, kw):
        out = orig(*a, **kw)
        args = _SIG.bind(*a, **kw).arguments
        out[0].copy_(args["gcT"])
        out[1].copy_(args["gvT"])
        return out
    return _wrap_kernel(change)


def half_batch():
    """The second half of the envs keeps its state: the kernel steps half."""
    return _unstepped_tail(0.5)


def minority_unstepped():
    """The last tenth of the envs (one at least) keeps its state."""
    return _unstepped_tail(0.1)


def _unstepped_tail(share: float):
    def change(orig, a, kw):
        out = orig(*a, **kw)
        args = _SIG.bind(*a, **kw).arguments
        n = args["gcT"].shape[1]
        h = n - max(1, int(share * n))
        out[0][:, h:] = args["gcT"][:, h:]
        out[1][:, h:] = args["gvT"][:, h:]
        return out
    return _wrap_kernel(change)
