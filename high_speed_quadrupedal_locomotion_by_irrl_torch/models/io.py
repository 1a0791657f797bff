"""Weight interop: the bp5 CSV deployment format, and carrying the JAX
package's policy weights over to the port.

Port of ``models/io.load_bp5_csv``: the files lstm_w{x,h}{i}.csv,
lstm_b{i}.csv and pi_{w,b}.csv (CustomerLstmNN.save_model, :203-224), with the
value tower (v_lstm_*.csv, v_w.csv, v_b.csv) and logstd.csv loaded when
present, and a fresh init in their place when absent. Files are read with
numpy only.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.models.lstm import (
    LSTMWeights, PolicyParams, init,
)


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


def policy_params_from_numpy(tree, device=None) -> PolicyParams:
    """Carry a JAX ``PolicyParams`` over to the port. ``tree`` has the JAX
    field names and holds numpy arrays (``jax.tree.map(np.asarray, params)``)."""
    device = dev_mod.resolve(device)
    t = lambda x: dev_mod.tensor(np.asarray(x), device)  # noqa: E731

    def stack(ws):
        return tuple(LSTMWeights(wx=t(w.wx), wh=t(w.wh), b=t(w.b)) for w in ws)

    return PolicyParams(pi_lstm=stack(tree.pi_lstm), v_lstm=stack(tree.v_lstm),
                        pi_w=t(tree.pi_w), pi_b=t(tree.pi_b), logstd=t(tree.logstd),
                        vf_w=t(tree.vf_w), vf_b=t(tree.vf_b))
