"""Closed-loop evaluation sweeps of the flagship controller:
``analysis/eval.policy_rollout``, as ``cli/test.py``'s evaluation modes run it.

A unit is one rollout of the traffic's batch of envs, each at its own fixed
command drawn from the seed, from fresh seeded starts, with deterministic
actions. Set-up loads the policy from the configuration's checkpoint and
runs one whole rollout, which warms up every shape and the allocator.

In the window's first rollout the policy's calls (``models/lstm.
deterministic_action``, the pair kernel) and the physics kernel's calls are
recorded at control steps drawn from the seed; once the window has closed the
plain reference takes each recorded step from the same inputs.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm

from irrl_bench.core import compare, measure, physics_check, port, traffic
from irrl_bench.counts import lstm as lstm_counts
from irrl_bench.counts import phys as phys_counts
from irrl_bench.reference import policy as ref_pol


def _keep_policy(a, kw, out) -> dict:
    _, obs, state, done = a[:4]
    return {"obs": obs.detach().clone(), "state": state.detach().clone(),
            "done": done.detach().clone(), "action": out[0].detach().clone(),
            "state_out": out[1].detach().clone()}


class Session:
    def __init__(self, ctx):
        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        self.B, self.T = tr["num_envs"], tr["n_steps"]
        self.env_cfg = ev._fixed_command_cfg(port.env_config(cfg, "test_env", self.B))
        ckpt = os.path.join(ctx.root, cfg["policy"]["checkpoint"])
        self.params = mio.load_bp5_csv(ckpt, n_lstm=tuple(cfg["policy"]["lstm_widths"]),
                                       device=ctx.device)
        picks = traffic.picks(ctx.seed, self.T, tr["checked_steps"])
        self.phys = physics_check.KernelRecorder(picks)
        self.policy = measure.Recorder(lstm, "deterministic_action", picks, _keep_policy)
        self.units = 0
        self._rollout(warm_up=True)

    def _rollout(self, warm_up: bool = False, n_steps: int | None = None) -> None:
        seq = np.random.SeedSequence([self.ctx.seed, self.units, int(warm_up)])
        gen = torch.Generator(device=self.ctx.device).manual_seed(
            int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        cmd = traffic.commands(self.ctx.traffic, self.ctx.seed, self.units, self.ctx.device)
        log = ev.policy_rollout(self.env_cfg, self.params, cmd, gen, n_steps or self.T,
                                device=self.ctx.device)
        del log

    def unit(self) -> float:
        with contextlib.ExitStack() as stack:
            if self.units == 0:
                for ctx in (self.ctx.faults(self), self.phys, self.policy):
                    stack.enter_context(ctx)
            self._rollout()
        self.units += 1
        return float(self.B * self.T)

    def layer_readings(self) -> dict:
        return {}

    def sites(self) -> dict:
        return {}

    def op_counts(self) -> dict:
        """PyTorch ops a control step: a 16-step rollout's less an 8-step one's, over 8."""
        k = 8
        ops = lambda n: measure.count_calls(lambda: self._rollout(n_steps=n))  # noqa: E731
        return {"rollout_step": (ops(2 * k) - ops(k)) / k}

    def work(self) -> dict:
        pol = self.ctx.config["policy"]
        widths, d = tuple(pol["lstm_widths"]), pol["obs_dim"]
        pair = []
        for n in widths:
            pair.append((self.B * lstm_counts.pair_ops(d, n), lstm_counts.pair_bytes(self.B, d, n)))
            d = n
        env_ops = phys_counts.ops_per_env(self.env_cfg.substeps,
                                          motor_dynamics=self.env_cfg.motor_dynamics)
        step = lstm_counts.policy_step_ops(pol["obs_dim"], widths, pol["act_dim"]) + env_ops
        return {"unit_ops": self.T * self.B * step, "pair_kernel": pair,
                "phys_kernel": [(self.B * env_ops, self.B * phys_counts.bytes_per_env())]}

    def release(self) -> None:
        self.params = None

    def numbers(self, control: bool = False) -> dict:
        dev, cfg = self.ctx.device, self.ctx.config
        w = ref_pol.load_csv(os.path.join(self.ctx.root, cfg["policy"]["checkpoint"]),
                             len(cfg["policy"]["lstm_widths"]), dev)
        prog = self.phys.numbers(cfg["test_env"], cfg["contact"], dev)
        prog.update(self._policy_numbers(w, None))
        if not control:
            return prog
        ctl = self.phys.numbers(cfg["test_env"], cfg["contact"], dev, control=True)
        ctl.update(self._policy_numbers(w, True))
        return {"program": prog, "control": ctl}

    def _policy_numbers(self, w, control) -> dict:
        """Widest gaps of the recorded steps' actions and recurrent states
        from the reference's, each over the reference's RMS."""
        if not self.policy.kept:
            return {"action_gap": float("nan"), "lstm_state_gap": float("nan")}
        act, state = 0.0, 0.0
        for r in self.policy.kept.values():
            def step(tf32):
                with compare.precision(tf32), torch.no_grad():
                    out = ref_pol.step(w, r["obs"], r["state"], r["done"])
                return torch.clamp(out.mean, -1.0, 1.0), out.state
            want_a, want_s = step(False)
            got_a, got_s = step(True) if control else (r["action"], r["state_out"])
            act = compare.worst(act, compare.widest(got_a, want_a, compare.rms(want_a)))
            state = compare.worst(state, compare.widest(got_s, want_s, compare.rms(want_s)))
        return {"action_gap": act, "lstm_state_gap": state}


def setup(ctx) -> Session:
    return Session(ctx)


def faults(session, name: str):
    if name == "unchanged":
        return physics_check.unchanged_state()
    if name == "half":
        return physics_check.half_batch()
    if name == "minority":
        return physics_check.minority_unstepped()
    if name == "altered":     # one env's action altered where the policy makes it
        def make(orig):
            def run(*a, **kw):
                action, state = orig(*a, **kw)
                return action.index_add(0, torch.zeros(1, dtype=torch.long, device=action.device),
                                        torch.full_like(action[:1], 0.01)), state
            return run
        return measure.Patch(lstm, "deterministic_action", make)
    raise ValueError(f"unknown fault {name!r}")
