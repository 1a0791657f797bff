"""Reward-landscape study over the policy-parameter simplex.

Port of ``analysis/landscape.py``. The reference's hyperplane analysis
(readme.md:3) is backed by Exp_Raw_Data/total_reward.txt: 5152 rows sweeping
barycentric weights (w0, w1, w2=1-w0-w1) over three trained controllers and
recording the accumulated per-term rewards of each *parameter-interpolated*
policy (rendered as ternary contour panels in Figure2.py:362-460).

The sweep is one batch a chunk of blends: every env of the batch runs its
own blended policy (``models/lstm.forward`` with one weight set a row, the
per-row LSTM kernel on the card; the JAX package ``vmap``s the policy over
stacked params), all rolled in lockstep through ``step_batch`` (the fused
physics kernel), or the per-env ``step`` under hard contact or the attacks.

Column mapping to the reference file (Figure2.py:388-392): the env's term
vector [EE, BodyPos, BodyAtti, J, Jdot, Vel, Torque, Contact]
(envs/blackpanther.py reward_terms) aggregates exactly the composites the
figure uses — mimic = 0.25 mimic_q + 0.75 mimic_dq is the J+Jdot pair,
velocity = 0.5 lin + 0.5 ang is Vel, torque = 0.5 tau + 0.5 dtau is Torque,
balance = 0.5 height + 0.5 attitude is the BodyPos+BodyAtti pair — so the
five panels (r^f composite, r^v, r^m, r^b, r^t) are computed exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.config import EnvConfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm

TERM_NAMES = ("ee", "body_pos", "body_atti", "mimic_q", "mimic_dq",
              "cmd_vel", "torque", "contact")


def simplex_grid(step: float = 0.02) -> np.ndarray:
    """(N, 3) barycentric weights covering the simplex (w0+w1+w2=1)."""
    n = int(round(1.0 / step))
    pts = [(i * step, j * step, 1.0 - (i + j) * step)
           for i in range(n + 1) for j in range(n + 1 - i)]
    return np.asarray(pts, dtype=np.float32)


def blend_params(params_list, w) -> lstm.PolicyParams:
    """Parameter-space interpolation sum_k w_k theta_k (the hyperplane).

    w: (K,) gives one blend; (B, K) gives B blends stacked on a leading row
    axis, the per-row ``PolicyParams`` of ``models/lstm.forward``."""
    named = [dict(p.named_leaves()) for p in params_list]
    w = dev_mod.tensor(w, named[0]["pi_b"].device)

    def blend(name):
        parts = [leaves[name] for leaves in named]
        if w.dim() == 1:
            return sum(wk * leaf for wk, leaf in zip(w, parts))
        return sum(w[:, k].reshape((-1,) + (1,) * leaf.dim()) * leaf
                   for k, leaf in enumerate(parts)).contiguous()

    def stack(tower):
        return tuple(lstm.LSTMWeights(**{k: blend(f"{tower}.{i}.{k}") for k in ("wx", "wh", "b")})
                     for i in range(len(getattr(params_list[0], tower))))
    return lstm.PolicyParams(pi_lstm=stack("pi_lstm"), v_lstm=stack("v_lstm"),
                             **{k: blend(k) for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")})


def _landscape_batch(cfg: EnvConfig, stacked_params: lstm.PolicyParams, command,
                     gen: torch.Generator, n_steps: int = 750, device=None):
    """Accumulated reward terms for a batch of policies in lockstep.

    stacked_params: PolicyParams with a leading blend axis B.
    Returns (terms (B, 8), alive_len (B,)). Accumulation stops at each
    policy's first termination (the episode the reference sweep scores)."""
    device = dev_mod.resolve(device)
    B = stacked_params.pi_b.shape[0]
    cfg = ev._fixed_command_cfg(cfg)
    cmd = dev_mod.tensor(command, device).reshape(3).expand(B, 3)
    state = bp.env_init(cfg, B, gen, device).replace(command=cmd, command_filtered=cmd)
    obs = bp.observe(cfg, state)
    s_size = lstm.state_size([w.wh.shape[-2] for w in stacked_params.pi_lstm])
    cmd_n = (cmd - bp.obs_mean(cfg, device)[:3]) / bp.obs_std(cfg, device)[:3]
    env_step = ev.env_step(cfg)
    lstm_state = torch.zeros((B, s_size), device=device)
    no_reset = torch.zeros(B, device=device)
    alive = torch.ones(B, device=device)
    acc = torch.zeros((B, 8), device=device)
    alen = torch.zeros(B, device=device)
    for _ in range(n_steps):
        o = torch.cat([cmd_n, obs[:, 3:]], dim=-1)
        action, lstm_state = lstm.deterministic_action(stacked_params, o, lstm_state, no_reset)
        out = env_step(cfg, state.replace(command=cmd, command_filtered=cmd), action, gen)
        acc = acc + out.info["reward_terms"] * alive[:, None]
        alen = alen + alive
        alive = alive * (1.0 - out.done.to(alive.dtype))
        state, obs = out.state, out.obs
    return acc, alen


def reward_landscape(cfg: EnvConfig, params_a, params_b, params_c,
                     command=(2.0, 0.0, 0.0), step: float = 0.02,
                     n_steps: int = 750, gen: torch.Generator | None = None,
                     chunk: int = 512, device=None):
    """The full sweep: blend grid x rollout x per-term accumulation, ``chunk``
    blends a batch.

    params_{a,b,c}: the three anchor controllers (e.g. imitation-trained,
    relaxation-trained, reference bp5_155 — the Theta^m / Theta^v / Theta^f
    vertices of Figure2's ternary panels), on ``device``.
    Returns dict with 'w' (N,3), 'terms' (N,8), 'alive_len' (N,)."""
    device = dev_mod.resolve(device)
    gen = torch.Generator(device=device).manual_seed(0) if gen is None else gen
    w = simplex_grid(step)
    plist = [params_a, params_b, params_c]
    terms_out, alen_out = [], []
    for i in range(0, len(w), chunk):
        stacked = blend_params(plist, w[i:i + chunk])
        t, al = _landscape_batch(cfg, stacked, command, gen, n_steps, device)
        terms_out.append(t.cpu().numpy())
        alen_out.append(al.cpu().numpy())
    return {"w": w, "terms": np.concatenate(terms_out),
            "alive_len": np.concatenate(alen_out)}


def composites(cfg: EnvConfig, terms: np.ndarray) -> dict:
    """The five Figure-2 panel quantities from the 8-term accumulators,
    divided by the run's reward coefficients so the panels are
    coefficient-free like the reference's raw columns (Figure2.py:388-396)."""
    def safe(c):
        return c if abs(c) > 1e-12 else 1.0
    r_v = terms[:, 5] / safe(cfg.vel_keep_coeff)
    r_m = (terms[:, 3] + terms[:, 4]) / safe(cfg.joint_mimic_coeff)
    r_b = (0.5 * terms[:, 1] / safe(cfg.body_pos_coeff)
           + 0.5 * terms[:, 2] / safe(cfg.body_atti_coeff))
    r_t = terms[:, 6] / safe(cfg.torque_coeff)
    ratio = np.array([0.3, 0.1, 0.3, 0.3])   # Figure2.py:396
    r_f = np.stack([r_v, r_m, r_b, r_t], axis=1) @ ratio
    return {"r_f": r_f, "r_v": r_v, "r_m": r_m, "r_b": r_b, "r_t": r_t}


def save_total_reward(path: str, cfg: EnvConfig, res: dict) -> None:
    """Write the sweep in the reference's total_reward.txt layout
    (space-separated, w0 w1 + term columns; Exp_Raw_Data/total_reward.txt)."""
    terms = res["terms"]

    def safe(c):
        return c if abs(c) > 1e-12 else 1.0
    # The env aggregates sub-term pairs with the reference's own intra-pair
    # weights (0.25/0.75 mimic, 0.5/0.5 velocity and torque). The raw file's
    # consumers recombine pairs with exactly those weights (Figure2.py:388-392),
    # so writing each pair's *composite* into both columns reproduces the
    # figure quantities exactly (the independent sub-splits are not observable
    # from the aggregated terms).
    mimic = (terms[:, 3] + terms[:, 4]) / safe(cfg.joint_mimic_coeff)
    vel = terms[:, 5] / safe(cfg.vel_keep_coeff)
    tau = terms[:, 6] / safe(cfg.torque_coeff)
    cols = {
        "w0": res["w"][:, 0], "w1": res["w"][:, 1],
        "height_keep": terms[:, 1] / safe(cfg.body_pos_coeff),
        "balance_keep": terms[:, 2] / safe(cfg.body_atti_coeff),
        "mimic_q": mimic, "mimic_dq": mimic,
        "cmd_linear": vel, "cmd_angular": vel,
        "torque": tau, "torque_d": tau,
        "contact": terms[:, 7],
        "terminal": (res["alive_len"] < res["alive_len"].max()).astype(float),
    }
    header = " ".join(cols.keys())
    data = np.stack(list(cols.values()), axis=1)
    np.savetxt(path, data, header=header, comments="", fmt="%.6g")
