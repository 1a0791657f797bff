"""Weight and checkpoint interop.

Port of ``models/io.py``. Two serialization surfaces:

1. **bp5 CSV format**: the files lstm_w{x,h}{i}.csv, lstm_b{i}.csv and
   pi_{w,b}.csv (CustomerLstmNN.save_model, :203-224), with the value tower
   (v_lstm_*.csv, v_w.csv, v_b.csv) and logstd.csv loaded when present, and a
   fresh init in their place when absent. Files are read and written with
   numpy only. This directory is the format in which the port and the JAX
   package exchange controllers, in both directions.
2. **checkpoints**: a pickle of plain dicts of numpy arrays: the parameters by
   leaf name (``PolicyParams.named_leaves``), Adam's moments by the same
   names, its step count and learning rate, the update counter and, for a
   run on terrain, the terrain height scale it had reached. The JAX
   package's ``.pkl`` checkpoints pickle its own classes, so unpickling them
   imports JAX: the port does not read them; export such a controller as a
   CSV directory instead.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (
    LSTMWeights, PolicyParams, init,
)
from high_speed_quadrupedal_locomotion_by_irrl_torch.models.mlp import MlpParams


def load_bp5_csv(path: str, n_lstm: Sequence[int] = (48, 48), act_dim: int = 12,
                 obs_dim: int = 35, device=None) -> PolicyParams:
    """Load a reference CSV export (e.g. artifacts/irrl_tpu_relaxed_4e8/)."""
    device = dev_mod.resolve(device)

    def ld(name):
        # parsed as float64 and then rounded, as the JAX loader does
        return dev_mod.tensor(np.loadtxt(os.path.join(path, name + ".csv"), delimiter=","),
                              device)

    pi_stack = tuple(
        LSTMWeights(wx=ld(f"lstm_wx{i}"), wh=ld(f"lstm_wh{i}"), b=ld(f"lstm_b{i}"))
        for i in range(len(n_lstm)))
    # value tower / logstd are not part of the deployment export
    blank = init(torch.Generator(device=device).manual_seed(0), obs_dim, act_dim,
                 n_lstm, device)
    if os.path.exists(os.path.join(path, "v_lstm_wx0.csv")):
        v_stack = tuple(
            LSTMWeights(wx=ld(f"v_lstm_wx{i}"), wh=ld(f"v_lstm_wh{i}"), b=ld(f"v_lstm_b{i}"))
            for i in range(len(n_lstm)))
        # savetxt writes the (h, 1) head as one column; restore the 2-d shape
        vf_w, vf_b = ld("v_w").reshape(-1, 1), torch.atleast_1d(ld("v_b"))
    else:
        v_stack, vf_w, vf_b = blank.v_lstm, blank.vf_w, blank.vf_b
    if os.path.exists(os.path.join(path, "logstd.csv")):
        logstd = torch.atleast_1d(ld("logstd"))
    else:
        logstd = blank.logstd
    return PolicyParams(pi_lstm=pi_stack, v_lstm=v_stack, pi_w=ld("pi_w"), pi_b=ld("pi_b"),
                        logstd=logstd, vf_w=vf_w, vf_b=vf_b)


def save_bp5_csv(params: PolicyParams, path: str, include_value: bool = True) -> None:
    """Export in the reference CSV format (save_model parity, fmt %.6f)."""
    os.makedirs(path, exist_ok=True)

    def sv(name, t):
        np.savetxt(os.path.join(path, name + ".csv"), t.detach().cpu().numpy(),
                   delimiter=",", fmt="%.6f")

    for i, w in enumerate(params.pi_lstm):
        sv(f"lstm_wx{i}", w.wx), sv(f"lstm_wh{i}", w.wh), sv(f"lstm_b{i}", w.b)
    sv("pi_w", params.pi_w), sv("pi_b", params.pi_b)
    if include_value:
        for i, w in enumerate(params.v_lstm):
            sv(f"v_lstm_wx{i}", w.wx), sv(f"v_lstm_wh{i}", w.wh), sv(f"v_lstm_b{i}", w.b)
        sv("v_w", params.vf_w), sv("v_b", params.vf_b)
        sv("logstd", params.logstd)


def policy_params_to_numpy(params: PolicyParams) -> dict:
    """{leaf name: numpy array}, names as ``PolicyParams.named_leaves`` gives
    them ("pi_lstm.0.wx", ..., "vf_b"). The inverse of
    :func:`policy_params_from_numpy`."""
    return {k: t.detach().cpu().numpy().copy() for k, t in params.named_leaves()}


def _unflatten(flat: dict):
    """The dict of :func:`policy_params_to_numpy` as a PolicyParams of numpy arrays."""
    def stack(tower):
        n = len({k.split(".")[1] for k in flat if k.startswith(tower + ".")})
        return tuple(LSTMWeights(*(flat[f"{tower}.{i}.{k}"] for k in ("wx", "wh", "b")))
                     for i in range(n))
    return PolicyParams(pi_lstm=stack("pi_lstm"), v_lstm=stack("v_lstm"),
                        **{k: flat[k] for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")})


def policy_params_from_numpy(tree, device=None) -> PolicyParams:
    """Carry policy parameters held as numpy arrays over to the port. ``tree``
    is a JAX ``PolicyParams`` (``jax.tree.map(np.asarray, params)``: the JAX
    field names as attributes) or the dict of :func:`policy_params_to_numpy`."""
    device = dev_mod.resolve(device)
    if isinstance(tree, dict):
        tree = _unflatten(tree)
    t = lambda x: dev_mod.tensor(np.asarray(x), device)  # noqa: E731

    def stack(ws):
        return tuple(LSTMWeights(wx=t(w.wx), wh=t(w.wh), b=t(w.b)) for w in ws)

    return PolicyParams(pi_lstm=stack(tree.pi_lstm), v_lstm=stack(tree.v_lstm),
                        pi_w=t(tree.pi_w), pi_b=t(tree.pi_b), logstd=t(tree.logstd),
                        vf_w=t(tree.vf_w), vf_b=t(tree.vf_b))


def mlp_params_to_numpy(params: MlpParams) -> dict:
    """{leaf name: numpy array}, names as ``MlpParams.named_leaves`` gives them
    ("pi_layers.0.w", ..., "vf_b"). The inverse of :func:`mlp_params_from_numpy`."""
    return policy_params_to_numpy(params)


def mlp_params_from_numpy(tree, device=None) -> MlpParams:
    """Carry MLP parameters held as numpy arrays over to the port. ``tree`` is
    a JAX ``MlpParams`` (``jax.tree.map(np.asarray, params)``) or the dict of
    :func:`mlp_params_to_numpy`."""
    device = dev_mod.resolve(device)
    t = lambda x: dev_mod.tensor(np.asarray(x), device)  # noqa: E731
    if isinstance(tree, dict):
        def stack(tower):
            n = len({k.split(".")[1] for k in tree if k.startswith(tower + ".")})
            return tuple((t(tree[f"{tower}.{i}.w"]), t(tree[f"{tower}.{i}.b"])) for i in range(n))
        get = tree.__getitem__
    else:
        def stack(tower):
            return tuple((t(w), t(b)) for w, b in getattr(tree, tower))
        get = lambda k: getattr(tree, k)  # noqa: E731
    return MlpParams(pi_layers=stack("pi_layers"), v_layers=stack("v_layers"),
                     **{k: t(get(k)) for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b")})


def adam_state_to_numpy(opt: torch.optim.Adam, params: PolicyParams) -> dict:
    """Adam's state as plain values: first and second moments by leaf name,
    the step count and the learning rate. Before the first step the moments
    are zeros and the count 0."""
    mu, nu, count = {}, {}, 0
    for name, p in params.named_leaves():
        st = opt.state.get(p, {})
        mu[name] = st["exp_avg"].cpu().numpy().copy() if st else np.zeros(p.shape, np.float32)
        nu[name] = st["exp_avg_sq"].cpu().numpy().copy() if st else np.zeros(p.shape, np.float32)
        count = int(st["step"]) if st else count
    return {"mu": mu, "nu": nu, "count": count, "lr": float(opt.param_groups[0]["lr"])}


def adam_state_from_numpy(opt: torch.optim.Adam, params: PolicyParams, state: dict) -> bool:
    """Set ``opt`` (made over ``params.leaves()``) to ``state`` as
    :func:`adam_state_to_numpy` gives it; ``lr`` is optional. Returns False,
    leaving ``opt`` as it was, if ``state`` does not fit the parameters."""
    named = params.named_leaves()
    try:
        fits = all(tuple(state[m][k].shape) == tuple(p.shape) for m in ("mu", "nu")
                   for k, p in named) and all(len(state[m]) == len(named) for m in ("mu", "nu"))
        count = int(state["count"])
    except (KeyError, TypeError, AttributeError):
        return False
    if not fits:
        return False
    for name, p in named:
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": dev_mod.tensor(state["mu"][name], p.device).clone(),
                        "exp_avg_sq": dev_mod.tensor(state["nu"][name], p.device).clone()}
    if state.get("lr") is not None:
        for group in opt.param_groups:
            group["lr"] = float(state["lr"])
    return True


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Reads dicts, numbers and numpy arrays, and imports nothing else."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"holds a {module}.{name} object")


def save_checkpoint(path: str, params: PolicyParams, opt: Optional[torch.optim.Adam],
                    step: Optional[int] = None,
                    terrain_z_scale: Optional[float] = None) -> None:
    """Full-state checkpoint: plain dicts of numpy arrays, pickled."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"step": step, "params": policy_params_to_numpy(params),
            "adam": None if opt is None else adam_state_to_numpy(opt, params),
            "terrain_z_scale": terrain_z_scale}
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def load_checkpoint(path: str, device=None):
    """-> (params, adam state dict or None, step). The adam state goes to
    :func:`adam_state_from_numpy` (``algo.ppo.learn(opt_state=...)``)."""
    not_ours = (f"{path!r} is not a checkpoint of the PyTorch port (the JAX package's .pkl "
                "checkpoints are not read; export the controller as a bp5 CSV directory)")
    with open(path, "rb") as f:
        try:
            blob = _NumpyOnlyUnpickler(f).load()
        except pickle.UnpicklingError as e:
            raise ValueError(f"{not_ours}: {e}") from None
    if not (isinstance(blob, dict) and isinstance(blob.get("params"), dict)):
        raise ValueError(not_ours)
    return policy_params_from_numpy(blob["params"], device), blob.get("adam"), blob.get("step")
