"""PyTorch port: the whole evaluation slice against the JAX package.

A 10-step closed-loop ``policy_rollout`` of the flagship artifact at commands
1 and 4 m/s, both commands in one batch of the port, each against its own
JAX rollout; and the port's ``cli.test`` end to end on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as tev
from high_speed_quadrupedal_locomotion_by_irrl_torch.cli import test as tcli
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import eval as jev
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio

torch.set_num_threads(1)

ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
COMMANDS = np.array([[1.0, 0.0, 0.0], [4.0, 0.0, 0.0]], np.float32)


def test_policy_rollout_matches_jax():
    T = 10
    jp = jio.load_bp5_csv(ARTIFACT)
    jcfg = jev._fixed_command_cfg(jconfig.test_default())
    tcfg = tev._fixed_command_cfg(tconfig.test_default())
    ref = [jax.tree.map(np.asarray, jev.policy_rollout(jcfg, jp, jnp.asarray(c),
                                                       jax.random.PRNGKey(10), T))
           for c in COMMANDS]
    got = tev.policy_rollout(tcfg, tio.load_bp5_csv(ARTIFACT, device="cpu"), COMMANDS,
                             torch.Generator().manual_seed(10), T, device="cpu")
    assert got.gc.shape == (T, 2, 19) and got.lstm_state.shape == (T, 2, 384)
    for b, r in enumerate(ref):
        # 80 substeps of the batched lanes physics against the JAX per-env
        # dynamics (another summation order), fed back through the policy:
        # the trajectory tolerances of test_phys_lanes.py:99-100
        np.testing.assert_allclose(got.gc[:, b].numpy(), r.gc, atol=1e-3)
        np.testing.assert_allclose(got.gv[:, b].numpy(), r.gv, atol=5e-2)
        np.testing.assert_allclose(got.action[:, b].numpy(), r.action, atol=5e-3)
        np.testing.assert_array_equal(got.done[:, b].numpy(), r.done)
    # tracking stats of the batched log equal the JAX rows of each command
    vb = tev.body_velocity(got)
    for b, r in enumerate(ref):
        np.testing.assert_allclose(vb[:, b], jev.body_velocity(
            jax.tree.map(jnp.asarray, r)), atol=5e-3)


def test_batched_rollout_is_per_env():
    """An env of a batch computes what a rollout of its command alone does."""
    T = 3
    params = tio.load_bp5_csv(ARTIFACT, device="cpu")
    cfg = tev._fixed_command_cfg(tconfig.test_default())
    batch = tev.policy_rollout(cfg, params, COMMANDS, torch.Generator().manual_seed(0), T,
                               device="cpu")
    one = tev.policy_rollout(cfg, params, COMMANDS[1], torch.Generator().manual_seed(0), T,
                             device="cpu")
    assert one.gc.shape == (T, 19)
    for name in ("gc", "gv", "action", "lstm_state"):
        # the CPU BLAS may block a 1-row product differently from a 2-row one
        torch.testing.assert_close(getattr(one, name), getattr(batch, name)[:, 1],
                                   atol=1e-5, rtol=1e-5)


def test_cli_test_eval_runs_on_cpu(capsys):
    res = tcli.main(["--model", ARTIFACT, "--eval", "--commands", "1,4", "--steps", "10",
                     "--device", "cpu"])
    rows = res["tracking"]
    assert [r["command"] for r in rows] == [1.0, 4.0]
    for r in rows:
        assert np.isfinite([r["v_mean"], r["v_std"], r["err_mean"], r["err_std"]]).all()
        assert r["falls"] == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("cmd ")]
    assert lines[0].startswith("cmd 1.0 m/s -> v ") and len(lines) == 2
