"""PPO updates of the flagship LSTM controller: ``algo/ppo.make_update_fn``.

Set-up builds the one training object (the train state with its policy,
loaded from the configuration's checkpoint, its Adam state and its envs,
from the seed) and drives it through its first update, which warms up every
shape and is recorded: the physics kernel's inputs and outputs at control
steps drawn from the seed, the rollout's batch, the first three optimizer
steps' losses, Adam's first moment after the first step and the parameters
after the third. The window then runs whole updates on that same object.

Once the window has closed and the program's state is freed, the plain
reference (``reference/``) follows the program: the physics step from each
recorded state, the policy over the rollout's observations (its values, the
log-probabilities of the actions taken, the GAE returns), and three
optimizer steps from the checkpoint on the rollout's batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import sys

import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.algo import ppo
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio

from irrl_bench.core import compare, measure, physics_check, port, traffic
from irrl_bench.counts import lstm as lstm_counts
from irrl_bench.counts import phys as phys_counts
from irrl_bench.reference import policy as ref_pol
from irrl_bench.reference import ppo as ref_ppo

N_CHECKED_STEPS = 3   # optimizer steps the reference follows


class Session:
    def __init__(self, ctx):
        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        self.B, self.T = tr["num_envs"], tr["n_steps"]
        self.env_cfg = port.env_config(cfg, "train_env", self.B).replace(use_lanes_physics=True)
        self.ppo_cfg = port.ppo_config(cfg, self.T)
        p = cfg["ppo"]
        opt_args = (self.ppo_cfg.learning_rate, (0.9, 0.999), 1e-5)
        if (p["learning_rate"], tuple(p["adam_betas"]), p["adam_eps"]) != opt_args:
            raise ValueError(f"the configuration's Adam {p} is not the port's {opt_args}")
        ckpt = os.path.join(ctx.root, cfg["policy"]["checkpoint"])
        params = mio.load_bp5_csv(ckpt, n_lstm=self.ppo_cfg.n_lstm, device=ctx.device)
        self.start = {k: t.detach().clone() for k, t in params.named_leaves()}
        self.ts = ppo.init_train_state(self.env_cfg, self.ppo_cfg, ctx.seed, params, ctx.device)
        self.update = ppo.make_update_fn(self.env_cfg, self.ppo_cfg)
        self.phys = physics_check.KernelRecorder(
            traffic.picks(ctx.seed, self.T, tr["checked_steps"]))
        self.timings: list[dict] = []
        with ctx.faults(self), self.phys, self._capture():
            self.unit()
        self.timings.clear()

    @contextlib.contextmanager
    def _capture(self):
        """Records the first update's batch and its first optimizer steps."""
        self.cap = {"losses": []}
        names = [k for k, _ in self.ts.params.named_leaves()]

        def rollout(orig):
            def run(env_cfg, ppo_cfg, ts, timings=None):
                with measure.Patch(bp, "step_batch", keep_obs):
                    new_ts, batch, ep = orig(env_cfg, ppo_cfg, ts, timings)
                cpu = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731
                self.cap["batch"] = ref_ppo.Batch(
                    obs=cpu(batch.obs), actions=cpu(batch.actions), values=cpu(batch.values),
                    neglogpacs=cpu(batch.neglogpacs), returns=cpu(batch.returns),
                    dones_before=cpu(batch.dones_before), init_state=cpu(batch.init_lstm_state))
                self.cap["rewards"] = cpu(batch.rewards)
                self.cap["dones_last"] = cpu(new_ts.dones)
                self.cap["obs_last"] = cpu(self.cap["obs_last"])
                return new_ts, batch, ep
            return run

        def keep_obs(orig):   # the last step's observation, the bootstrap value's input
            def run(*a, **kw):
                out = orig(*a, **kw)
                self.cap["obs_last"] = out.obs
                return out
            return run

        def minibatch(orig):
            def run(params, opt, *a, **kw):
                out = orig(params, opt, *a, **kw)
                k = len(self.cap["losses"])
                if k < N_CHECKED_STEPS:
                    self.cap["losses"].append(out["loss"].detach().clone())
                    leaves = params.leaves()
                    if k == 0:   # the gradient as Adam got it: its first moment / (1 - beta1)
                        self.cap["grad1"] = {
                            n: (opt.state[p]["exp_avg"] / 0.1 if "exp_avg" in opt.state.get(p, {})
                                else torch.zeros_like(p)).detach().to("cpu", copy=True)
                            for n, p in zip(names, leaves)}
                    if k == N_CHECKED_STEPS - 1:
                        self.cap["params3"] = {n: p.detach().to("cpu", copy=True)
                                               for n, p in zip(names, leaves)}
                return out
            return run

        with measure.Patch(ppo, "rollout", rollout), measure.Patch(ppo, "train_minibatch",
                                                                   minibatch):
            yield

    # --- the window ---------------------------------------------------------

    def unit(self) -> float:
        self.ts, metrics = self.update(self.ts)
        self.timings.append({k: float(metrics[k]) for k in
                             ("time_rollout_s", "time_gae_s", "time_epochs_s")})
        return float(self.B * self.T)

    def layer_readings(self) -> dict:
        return {"update_times": list(self.timings)}

    def sites(self) -> dict:
        return {}

    def op_counts(self) -> dict:
        """PyTorch ops a control step of the rollout (its loop and GAE):
        the ops of a 2k-step rollout less those of a k-step one, over k."""
        k = 8

        def ops(n):
            cfg = dataclasses.replace(self.ppo_cfg, n_steps=n)
            return measure.count_calls(lambda: ppo.rollout(self.env_cfg, cfg, self.ts))
        return {"rollout_step": (ops(2 * k) - ops(k)) / k}

    def work(self) -> dict:
        """The frozen operations of one update at this cell's shapes."""
        pol = self.ctx.config["policy"]
        widths = tuple(pol["lstm_widths"])
        env_ops = phys_counts.ops_per_env(self.env_cfg.substeps,
                                          motor_dynamics=self.env_cfg.motor_dynamics)
        seq = {}
        d = pol["obs_dim"]
        for i, n in enumerate(widths):
            seq[f"fwd{i}"] = (lstm_counts.seq_forward_ops(self.T, self.B, d, n),
                              lstm_counts.seq_forward_bytes(self.T, self.B, d, n))
            seq[f"bwd{i}"] = (lstm_counts.seq_backward_ops(self.T, self.B, d, n, dx=i > 0),
                              lstm_counts.seq_backward_bytes(self.T, self.B, d, n, dx=i > 0))
            d = n
        return {"unit_ops": lstm_counts.update_ops(self.T, self.B, self.ppo_cfg.noptepochs,
                                                   pol["obs_dim"], widths, pol["act_dim"],
                                                   env_ops),
                "seq_kernels": seq, "epochs": self.ppo_cfg.noptepochs}

    def release(self) -> None:
        self.ts = self.update = None

    # --- the comparison -----------------------------------------------------

    def numbers(self, control: bool = False) -> dict:
        """The program's readings (``control``: the TF32 reference's in the
        program's place, beside them)."""
        dev, cfg = self.ctx.device, self.ctx.config
        w = ref_pol.load_csv(os.path.join(self.ctx.root, cfg["policy"]["checkpoint"]),
                             len(cfg["policy"]["lstm_widths"]), dev)
        prog = {"start_gap": max(float((self.start[k] - t).abs().max()) for k, t in w.leaves())}
        prog.update(self.phys.numbers(cfg["train_env"], cfg["contact"], dev))
        b = ref_ppo.Batch(*(x.to(dev) for x in self.cap["batch"]))
        extra = (self.cap["obs_last"].to(dev), self.cap["dones_last"].to(dev),
                 self.cap["rewards"].to(dev))
        with compare.precision(False):
            want_seq = _rollout_policy(w, b, *extra, cfg["ppo"])
            want = ref_ppo.train_steps(w, b, cfg["ppo"], N_CHECKED_STEPS, self.ctx.ref_block)
        got_seq = (b.values, b.neglogpacs, b.returns)
        got = ref_ppo.Steps([float(x) for x in self.cap["losses"]], [self.cap["grad1"]],
                            [self.cap["params3"]])
        prog.update(_step_numbers(got_seq, want_seq, got, want, w))
        if not control:
            return prog
        ctl = {"start_gap": 0.0}
        ctl.update(self.phys.numbers(cfg["train_env"], cfg["contact"], dev, control=True))
        with compare.precision(True):
            ctl_seq = _rollout_policy(w, b, *extra, cfg["ppo"])
            ctl_steps = ref_ppo.train_steps(w, b, cfg["ppo"], N_CHECKED_STEPS, self.ctx.ref_block)
        ctl.update(_step_numbers(ctl_seq, want_seq, ctl_steps, want, w))
        return {"program": prog, "control": ctl}


def _rollout_policy(w, b: ref_ppo.Batch, obs_last, dones_last, rewards, ppo_cfg: dict):
    """The reference's values and log-probabilities over the rollout's
    observations, and its GAE returns: (values, neglogp, returns), (T, B)."""
    with torch.no_grad():
        obs = torch.cat([b.obs, obs_last[None]])
        dones = torch.cat([b.dones_before, dones_last[None].float()])
        seq = ref_pol.sequence(w, obs, dones, b.init_state)
        values = seq.value
        nlp = ref_pol.neglogp(seq.mean[:-1], w.logstd, b.actions)
        nonterminal = 1.0 - dones[1:]
        g, lam = ppo_cfg["gamma"], ppo_cfg["lam"]
        deltas = rewards + g * values[1:] * nonterminal - values[:-1]
        adv = torch.zeros_like(values[0])
        advs = torch.empty_like(rewards)
        for t in range(rewards.shape[0] - 1, -1, -1):
            adv = deltas[t] + g * lam * nonterminal[t] * adv
            advs[t] = adv
        return values[:-1], nlp, advs + values[:-1]


def _step_numbers(got_seq, want_seq, got: ref_ppo.Steps, want: ref_ppo.Steps, w) -> dict:
    """The rollout's policy outputs and the optimizer steps against the
    reference's: widest gaps of values, log-probabilities and returns (each
    over the reference's RMS); the worst relative gap of the three losses;
    the worst leaf's gap of the first gradient's norm; the median and the
    worst leaf's gap of the change after the steps (the worst leaf's swings
    from seed to seed: Adam moves an element by lr g / (|g| + eps), so
    elements whose gradients are near eps carry their rounding into the
    change; the median is steady), leaves whose reference gradient is at
    rounding (under a thousandth of the median leaf's) left out of the
    change."""
    (gv, gn, gr), (wv, wn, wr) = got_seq, want_seq
    out = {"value_gap": compare.widest(gv, wv, compare.rms(wv)),
           "logp_gap": compare.widest(gn, wn, compare.rms(wn)),
           "returns_gap": compare.widest(gr, wr, compare.rms(wr))}
    out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses))
    dev = wv.device
    g1 = {k: v.to(dev) for k, v in got.grads[0].items()}
    out["grad1_gap"] = compare.leaf_gap(g1, want.grads[0])
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in want.grads[0].items()}
    median = statistics.median(norms.values())
    skip = {k for k, v in norms.items() if v < 1e-3 * median}
    print(f"irrl_bench: leaves left out of the change: {sorted(skip) or 'none'}", file=sys.stderr)
    start = dict(w.leaves())
    change = lambda p: {k: p[k].to(dev) - start[k] for k in start}  # noqa: E731
    gaps = compare.leaf_gaps(change(got.params[-1]), change(want.params[-1]), skip)
    name = max(gaps, key=lambda k: gaps[k])
    vals = list(gaps.values())
    out["change3_gap"] = float("nan") if any(v != v for v in vals) else statistics.median(vals)
    out["change3_worst_gap"] = compare.worst(*vals)
    print(f"irrl_bench: change after three steps: median leaf {out['change3_gap']}, worst "
          f"leaf {name} {gaps[name]}", file=sys.stderr)
    return out


def setup(ctx) -> Session:
    return Session(ctx)


def faults(session, name: str):
    """The faults the comparison must catch, planted in the program."""
    if name == "unchanged":   # Adam's step leaves the parameters as they were
        opt = session.ts.opt_state
        return _attr(opt, "step", lambda *a, **k: None)
    if name == "half":        # each minibatch's loss over half of its envs
        return measure.Patch(ppo, "_select_envs",
                             lambda orig: lambda batch, idx: orig(batch, idx[: idx.numel() // 2]))
    if name == "minority":    # the physics kernel leaves the last tenth of the envs unstepped
        return physics_check.minority_unstepped()
    if name == "altered":     # one env's velocity altered where the physics kernel makes it
        return physics_check.alter_output()
    raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def _attr(obj, name, value):
    setattr(obj, name, value)
    try:
        yield
    finally:
        delattr(obj, name)

