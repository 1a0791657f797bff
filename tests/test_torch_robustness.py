"""PyTorch port: the robustness experiments (``analysis/robustness``) against
the JAX package.

- ``kick_rollout``: a lateral kick of 1 m/s at step 20 of 60, commands 1 and
  3 m/s as one batch of the port (its ``step_batch`` path, plain on the CPU),
  each against its own JAX rollout (JAX's per-env path): the body-frame
  velocity within 5e-3, heights within 1e-3, dones equal;
- ``entropy_ensemble_rollout`` at N = 64 for 40 steps, with JAX's own noise
  draw reproduced here through ``jax.random`` and handed to the port: the 7
  features within 2e-3 over the first 15 steps, ``died`` equal; and the
  noise's placement on one episode against JAX's ``init_one`` arithmetic.

JAX's side of both comparisons is read from
``tests/test_torch_robustness_refs.json`` (JAX compiles each of the two
rollouts for ~20 s on the CPU). Run as a script, the file writes it, or
prints the JAX references that ``chip_smoke.py`` phase 16 (c) holds the port
to:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_robustness.py refs
        rewrites tests/test_torch_robustness_refs.json (~1 min)
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_robustness.py kappa
        JAX's recovery_sweep of the flagship at cmd 1-5, kick 1 m/s, 1500
        steps, from its start and from one 1e-6 m higher and lower
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import robustness as trb
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import robustness as jrb
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio

torch.set_num_threads(1)

ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"
REFS = Path(__file__).resolve().parent / "test_torch_robustness_refs.json"
KICK_COMMANDS = (1.0, 3.0)
KICK_DV = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
KICK_STEPS, KICK_AT = 60, 20
ENSEMBLE_COMMAND = (2.0, 0.0, 0.0)
N_EPISODES, ENSEMBLE_STEPS, FEATURE_ROWS = 64, 40, 15
NUDGE_M = 1e-6


def jax_references() -> dict:
    """JAX's kick rollouts, its ensemble over the first FEATURE_ROWS steps
    and its unit noise draw, as the tests below compare them."""
    jp = jio.load_bp5_csv(ARTIFACT)
    kicks = [jax.tree.map(lambda x: np.asarray(x).tolist(), jrb.kick_rollout(
        jconfig.test_default(), jp, jnp.array([c, 0.0, 0.0]), jnp.asarray(KICK_DV),
        jax.random.PRNGKey(10), KICK_STEPS, KICK_AT)._asdict()) for c in KICK_COMMANDS]
    key = jax.random.PRNGKey(10)
    feats, died = jrb.entropy_ensemble_rollout(
        jconfig.test_default(), jp, jnp.asarray(ENSEMBLE_COMMAND), key, N_EPISODES,
        ENSEMBLE_STEPS, 1)
    return {"kick": kicks, "features": np.asarray(feats)[:FEATURE_ROWS].tolist(),
            "died": np.asarray(died).tolist(), "u": _jax_unit_noise(key, N_EPISODES).tolist()}


@pytest.fixture(scope="module")
def refs():
    return json.loads(REFS.read_text())


@pytest.fixture(scope="module")
def params():
    return jio.load_bp5_csv(ARTIFACT), tio.load_bp5_csv(ARTIFACT, device="cpu")


def test_kick_rollout_matches_jax(params, refs):
    _, tp = params
    cmds = np.array([[c, 0.0, 0.0] for c in KICK_COMMANDS], np.float32)
    got = trb.kick_rollout(tconfig.test_default(), tp, cmds, np.asarray(KICK_DV, np.float32),
                           torch.Generator().manual_seed(10), KICK_STEPS, KICK_AT, device="cpu")
    assert got.v_body.shape == (KICK_STEPS, 2, 3)
    for b, want in enumerate(refs["kick"]):
        # 480 substeps of the lanes physics against JAX's per-env dynamics through a kick
        np.testing.assert_allclose(got.v_body[:, b].numpy(), want["v_body"], atol=5e-3)
        np.testing.assert_allclose(got.z[:, b].numpy(), want["z"], atol=1e-3)
        np.testing.assert_array_equal(got.done[:, b].numpy(), want["done"])
    # the kick lands at step 20: the lateral speed jumps there and not before
    vy = got.v_body[:, 0, 1].abs()
    assert vy[:20].max() < 0.2 < vy[20]


def _jax_unit_noise(key, n: int) -> np.ndarray:
    """JAX entropy_ensemble_rollout's draw before the ENTROPY_NOISE scale:
    split(key) -> key_noise, split(key_noise, n), each split into (ku, kenv)."""
    _, key_noise = jax.random.split(key)

    def one(k):
        ku, _ = jax.random.split(k)
        return jax.random.uniform(ku, (6,), minval=-1.0, maxval=1.0)
    return np.asarray(jax.vmap(one)(jax.random.split(key_noise, n)))


def test_entropy_ensemble_rollout_matches_jax(params, refs):
    _, tp = params
    # JAX's own unit draw, reproduced through jax.random and handed to the port
    u = _jax_unit_noise(jax.random.PRNGKey(10), N_EPISODES)
    np.testing.assert_array_equal(u, np.asarray(refs["u"], np.float32))
    feats_t, died_t = trb.entropy_ensemble_rollout(
        tconfig.test_default(), tp, np.asarray(ENSEMBLE_COMMAND, np.float32),
        torch.Generator().manual_seed(0), N_EPISODES, ENSEMBLE_STEPS, 1, device="cpu", u=u)
    assert feats_t.shape == (ENSEMBLE_STEPS, N_EPISODES, 7)
    # the lanes physics against JAX's per-env dynamics from 64 kicked starts
    np.testing.assert_allclose(feats_t[:FEATURE_ROWS].numpy(), refs["features"], atol=2e-3)
    np.testing.assert_array_equal(died_t.numpy(), refs["died"])
    # an episode's features differ from another's only by its noise
    assert feats_t[0, :, :6].std(0).min() > 0


def test_entropy_noise_draw_and_placement(params):
    """The default draw is uniform in [-1, 1) from the generator; the scaled
    noise lands on [z, roll, pitch, z_dot, roll_dot, pitch_dot] as in JAX."""
    _, tp = params
    u = trb.entropy_noise(torch.Generator().manual_seed(3), 4096, "cpu")
    assert u.shape == (4096, 6) and -1.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.05
    cfg = tconfig.test_default()
    one = np.array([[0.5, -0.25, 1.0, 0.5, -1.0, 0.75]], np.float32)
    f0, _ = trb.entropy_ensemble_rollout(cfg, tp, [1.0, 0.0, 0.0],
                                         torch.Generator().manual_seed(0), 1, 1, 1,
                                         device="cpu", u=np.zeros((1, 6), np.float32))
    f1, _ = trb.entropy_ensemble_rollout(cfg, tp, [1.0, 0.0, 0.0],
                                         torch.Generator().manual_seed(0), 1, 1, 1,
                                         device="cpu", u=one)
    # after one control step the noised episode sits higher, rolled and pitched back
    assert float(f1[0, 0, 0] - f0[0, 0, 0]) > 0.005
    assert float(f1[0, 0, 1] - f0[0, 0, 1]) < -0.03
    assert float(f1[0, 0, 2] - f0[0, 0, 2]) > 0.1
    with pytest.raises(ValueError, match=r"\(2, 6\)"):
        trb.entropy_ensemble_rollout(cfg, tp, [1.0, 0.0, 0.0], torch.Generator(), 2, 1,
                                     device="cpu", u=one)


def kappa_references(n_steps: int = 1500, kick_step: int = 750,
                     commands=(1.0, 2.0, 3.0, 4.0, 5.0)) -> dict:
    """JAX's recovery_sweep at kick 1 m/s (the CLI's --kappa), and the same
    from a start 1e-6 m higher and lower: chip_smoke.py phase 16 (c)."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp

    jp = jio.load_bp5_csv(ARTIFACT)
    cfg = jconfig.test_default()
    real_init = jbp.env_init
    rows = {}
    for dz in (0.0, NUDGE_M, -NUDGE_M):
        jbp.env_init = lambda c, k, dz=dz: (lambda s: s._replace(gc=s.gc.at[2].add(dz)))(
            real_init(c, k))
        jax.clear_caches()   # kick_rollout's trace read env_init
        rows[dz] = jrb.recovery_sweep(cfg, jp, list(commands), [1.0], jax.random.PRNGKey(cfg.seed),
                                      n_steps, kick_step)
        print(f"dz {dz:g}: " + ", ".join(f"cmd {r['command']:g} kappa {r['kappa']:.4f} "
                                         f"r2 {r['r2']:.3f} survived {r['survived']}"
                                         for r in rows[dz]), file=sys.stderr, flush=True)
    jbp.env_init = real_init
    out = {}
    for i, cmd in enumerate(commands):
        base = rows[0.0][i]
        spread = max(abs(rows[dz][i]["kappa"] - base["kappa"]) for dz in (NUDGE_M, -NUDGE_M))
        out[cmd] = {"kappa": base["kappa"], "r2": base["r2"], "survived": base["survived"],
                    "v_fwd_ss": base["v_fwd_ss"], "nudge_spread": spread}
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["kappa"]:
        print(json.dumps(kappa_references()))
    elif sys.argv[1:] == ["refs"]:
        REFS.write_text(json.dumps(jax_references()) + "\n")
    else:
        raise SystemExit("usage: tests/test_torch_robustness.py refs | kappa")
