"""PyTorch port: the reward landscape (``analysis/landscape``) against the JAX
package.

- ``simplex_grid`` and ``blend_params`` exactly;
- the LSTM with one weight set a row (the plain version of the per-row
  kernel) against ``jax.vmap(lstm.deterministic_action)`` over stacked
  blends of the three 2×LSTM(48) artifacts, at 1e-5;
- ``_landscape_batch`` at step 0.5 (6 blends) for 30 control steps at 2 m/s
  (the port's ``step_batch`` path, plain on the CPU, against JAX's per-env
  path): ``alive_len`` equal, the accumulated terms within 2e-3 relative.

Run as a script, the file prints the JAX references of ``chip_smoke.py``
phase 16 (a):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_landscape.py refs
        JAX's _landscape_batch over the 15 blends of step 0.25 at 2 m/s for 750
        steps, from its start and from one 1e-6 m higher and lower
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as tconfig
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape as tls
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_tpu import config as jconfig
from high_speed_quadrupedal_locomotion_by_irrl_tpu.analysis import landscape as jls
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm

torch.set_num_threads(1)

ANCHORS = ("artifacts/irrl_tpu_imitation", "artifacts/irrl_tpu_relaxed",
           "artifacts/irrl_tpu_relaxed_4e8")
COMMAND = np.array([2.0, 0.0, 0.0], np.float32)
NUDGE_M = 1e-6


@pytest.fixture(scope="module")
def anchors():
    return ([jio.load_bp5_csv(a) for a in ANCHORS],
            [tio.load_bp5_csv(a, device="cpu") for a in ANCHORS])


def _jax_stack(jps, w):
    return jax.vmap(lambda ww: jls.blend_params(jps, ww))(jnp.asarray(w))


@pytest.mark.parametrize("step", [0.5, 0.1, 0.02])
def test_simplex_grid_matches_jax(step):
    np.testing.assert_array_equal(tls.simplex_grid(step), jls.simplex_grid(step))


def test_blend_params_matches_jax(anchors):
    jps, tps = anchors
    w = tls.simplex_grid(0.25)
    want = _jax_stack(jps, w)
    got = tls.blend_params(tps, w)
    assert tlstm.per_row(got)
    for (name, t), j in zip(got.named_leaves(), jax.tree.leaves(want)):
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    one = tls.blend_params(tps, w[4])
    for (name, t), j in zip(one.named_leaves(), jax.tree.leaves(jls.blend_params(jps, w[4]))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_per_row_lstm_matches_jax_vmap(anchors, rng):
    jps, tps = anchors
    w = tls.simplex_grid(0.2)      # 21 blends
    B = len(w)
    obs = rng.standard_normal((B, 35)).astype(np.float32)
    state = (0.5 * rng.standard_normal((B, 384))).astype(np.float32)
    done = (rng.random(B) < 0.3).astype(np.float32)
    a_j, s_j = jax.vmap(jlstm.deterministic_action)(
        _jax_stack(jps, w), jnp.asarray(obs)[:, None], jnp.asarray(state)[:, None],
        jnp.asarray(done)[:, None])
    stacked = tls.blend_params(tps, w)
    a_t, s_t = tlstm.deterministic_action(stacked, torch.as_tensor(obs),
                                          torch.as_tensor(state), torch.as_tensor(done))
    # float32 products in another summation order
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j)[:, 0], atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j)[:, 0], atol=1e-5)
    out = tlstm.forward(stacked, torch.as_tensor(obs), torch.as_tensor(state),
                        torch.as_tensor(done))
    assert out.value.shape == (B,) and out.logstd.shape == (B, 12)
    # row b is exactly weight set b run alone
    for b in (0, 7, B - 1):
        a1, s1 = tlstm.deterministic_action(tls.blend_params(tps, w[b]),
                                            torch.as_tensor(obs[b:b + 1]),
                                            torch.as_tensor(state[b:b + 1]),
                                            torch.as_tensor(done[b:b + 1]))
        torch.testing.assert_close(a1[0], a_t[b], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(s1[0], s_t[b], atol=1e-6, rtol=1e-6)


def test_landscape_batch_matches_jax(anchors):
    jps, tps = anchors
    w = tls.simplex_grid(0.5)
    acc_j, alen_j = jls._landscape_batch(jconfig.test_default(), _jax_stack(jps, w),
                                         jnp.asarray(COMMAND), jax.random.PRNGKey(0), 30)
    acc_t, alen_t = tls._landscape_batch(tconfig.test_default(), tls.blend_params(tps, w),
                                         COMMAND, torch.Generator().manual_seed(0), 30,
                                         device="cpu")
    np.testing.assert_array_equal(alen_t.numpy(), np.asarray(alen_j))
    # 240 substeps of the lanes physics against JAX's per-env dynamics, summed
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=2e-3, atol=1e-4)


def chip_references(step: float = 0.25, n_steps: int = 750) -> dict:
    """JAX's _landscape_batch over the blends of ``step`` at 2 m/s from the
    start and from one 1e-6 m higher and lower: chip_smoke.py phase 16 (a)."""
    from high_speed_quadrupedal_locomotion_by_irrl_tpu.envs import blackpanther as jbp

    jps = [jio.load_bp5_csv(a) for a in ANCHORS]
    w = jls.simplex_grid(step)
    real_init = jbp.env_init
    runs = {}
    for dz in (0.0, NUDGE_M, -NUDGE_M):
        jbp.env_init = lambda c, k, dz=dz: (lambda s: s._replace(gc=s.gc.at[2].add(dz)))(
            real_init(c, k))
        jax.clear_caches()   # _landscape_batch's trace read env_init
        acc, alen = jls._landscape_batch(jconfig.test_default(), _jax_stack(jps, w),
                                         jnp.asarray(COMMAND), jax.random.PRNGKey(0), n_steps)
        runs[dz] = (np.asarray(acc, np.float64), np.asarray(alen, np.float64))
        print(f"dz {dz:g}: alive {runs[dz][1].tolist()}", file=sys.stderr, flush=True)
    jbp.env_init = real_init
    acc, alen = runs[0.0]
    spread = np.max([np.abs(runs[dz][0] - acc) for dz in (NUDGE_M, -NUDGE_M)], axis=0)
    alen_spread = np.max([np.abs(runs[dz][1] - alen) for dz in (NUDGE_M, -NUDGE_M)], axis=0)
    return {"step": step, "n_steps": n_steps, "w": w.tolist(), "terms": acc.tolist(),
            "alive_len": alen.tolist(), "terms_nudge_spread": spread.tolist(),
            "alive_nudge_spread": alen_spread.tolist()}


if __name__ == "__main__":
    if sys.argv[1:] == ["refs"]:
        print(json.dumps(chip_references()))
    else:
        raise SystemExit("usage: tests/test_torch_landscape.py refs")
