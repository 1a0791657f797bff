"""PyTorch port: the LSTM cell and the actor-critic against the JAX package.

The cell is compared with JAX's ``lstm_cell`` and with the Pallas cell run in
interpret mode (as tests/test_ops.py:72-86 does); the policy with the
in-repo flagship artifact loaded by both packages' loaders. Inputs come from
numpy with a seed. The CUDA kernel (ops/lstm_cuda) is held against the plain
cell on the card in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape as tls
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as tio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm as tlstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import lstm_cuda
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import io as jio
from high_speed_quadrupedal_locomotion_by_irrl_tpu.models import lstm as jlstm
from high_speed_quadrupedal_locomotion_by_irrl_tpu.ops.lstm_pallas import fused_lstm_cell

torch.set_num_threads(1)

ARTIFACT = "artifacts/irrl_tpu_relaxed_4e8"


def _cell_inputs(B, d, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    return dict(wx=f(d, 4 * n, scale=0.2), wh=f(n, 4 * n, scale=0.2), b=f(4 * n, scale=0.1),
                x=f(B, d), c=f(B, n), h=f(B, n))


@pytest.mark.parametrize("d", [35, 48])
def test_lstm_cell_matches_jax_and_pallas_interpret(d):
    a = _cell_inputs(64, d, 48, d)
    jw = jlstm.LSTMWeights(wx=jnp.asarray(a["wx"]), wh=jnp.asarray(a["wh"]), b=jnp.asarray(a["b"]))
    tw = tlstm.LSTMWeights(wx=torch.from_numpy(a["wx"]), wh=torch.from_numpy(a["wh"]),
                           b=torch.from_numpy(a["b"]))
    jx, jc, jh = (jnp.asarray(a[k]) for k in "xch")
    tx, tc, th = (torch.from_numpy(a[k]) for k in "xch")
    c_ref, h_ref = jlstm.lstm_cell(jw, jx, jc, jh)
    c_pl, h_pl = fused_lstm_cell(jw, jx, jc, jh, interpret=True)
    for c, h in (tlstm.lstm_cell(tw, tx, tc, th), lstm_cuda.lstm_cell(tw, tx, tc, th)):
        # f32 gate products of length <= 96 summed in another order
        for want_c, want_h in ((c_ref, h_ref), (c_pl, h_pl)):
            np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=1e-5)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)


@pytest.mark.parametrize("d", [35, 48])
def test_lstm_cell_pair_matches_jax_towers_with_done_mask(d):
    """One layer of both towers in one call, some rows reset by the done
    mask: the plain pair (the CPU path of ops/lstm_cuda.lstm_cell_pair, here
    on strided views of one packed state) against the JAX package's _tower
    run once per tower."""
    B, n = 24, 48
    a0, a1 = _cell_inputs(B, d, n, d), _cell_inputs(B, d, n, d + 100)
    mask = (np.random.default_rng(d).random(B) < 0.4).astype(np.float32)
    assert 0 < mask.sum() < B
    jw = lambda a: jlstm.LSTMWeights(wx=jnp.asarray(a["wx"]), wh=jnp.asarray(a["wh"]),  # noqa: E731
                                     b=jnp.asarray(a["b"]))
    tw = lambda a: tlstm.LSTMWeights(wx=torch.from_numpy(a["wx"]), wh=torch.from_numpy(a["wh"]),  # noqa: E731
                                     b=torch.from_numpy(a["b"]))
    want = []
    for a in (a0, a1):
        _, [(c, h)] = jlstm._tower((jw(a),), [(jnp.asarray(a["c"]), jnp.asarray(a["h"]))],
                                   jnp.asarray(a["x"]), jnp.asarray(mask))
        want += [c, h]
    state = torch.from_numpy(np.concatenate([a0["c"], a0["h"], a1["c"], a1["h"]], -1))
    views = [state[:, i * n:(i + 1) * n] for i in range(4)]
    for fn in (tlstm.lstm_cell_pair, lstm_cuda.lstm_cell_pair):
        got = fn(tw(a0), tw(a1), torch.from_numpy(a0["x"]), torch.from_numpy(a1["x"]), *views,
                 torch.from_numpy(mask))
        for g, w in zip(got, want):   # f32 gate products of length <= 96, another order
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # rows with the mask set start from a zero state: their result ignores c and h
    zero = [torch.zeros_like(v) for v in views]
    got0 = tlstm.lstm_cell_pair(tw(a0), tw(a1), torch.from_numpy(a0["x"]),
                                torch.from_numpy(a1["x"]), *zero, None)
    for g, g0 in zip(got, got0):
        np.testing.assert_allclose(g.numpy()[mask == 1], g0.numpy()[mask == 1], atol=1e-6)


@pytest.mark.parametrize("v_layers", [(48,), (32, 48), (48, 32, 32)])
def test_forward_towers_of_different_shape_match_jax(v_layers):
    """A value tower shallower, deeper or of other widths than the policy
    tower: layers the towers share in shape go through the pair entry, the
    others through the single cell, and both agree with the JAX forward over
    a few recurrent steps with a done in the middle."""
    B, T = 3, 6
    ka, kb = jax.random.split(jax.random.PRNGKey(len(v_layers)))
    ja, jb = jlstm.init(ka, n_lstm=(48, 48)), jlstm.init(kb, n_lstm=v_layers)
    jp = ja._replace(v_lstm=jb.v_lstm, vf_w=jb.vf_w, vf_b=jb.vf_b)
    tp = tio.policy_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    S = 2 * (48 + 48) + 2 * sum(v_layers)
    rng = np.random.default_rng(11)
    obs = rng.normal(size=(T, B, 35)).astype(np.float32)
    done = np.zeros((T, B), np.float32)
    done[3, 1] = 1.0
    js, ts = jnp.zeros((B, S)), torch.zeros(B, S)
    for t in range(T):
        jo = jlstm.forward(jp, jnp.asarray(obs[t]), js, jnp.asarray(done[t]))
        to = tlstm.forward(tp, torch.from_numpy(obs[t]), ts, torch.from_numpy(done[t]))
        # f32 products summed in another order, carried through the steps
        np.testing.assert_allclose(to.mean.numpy(), np.asarray(jo.mean), atol=1e-5)
        np.testing.assert_allclose(to.value.numpy(), np.asarray(jo.value), atol=1e-5)
        np.testing.assert_allclose(to.state.numpy(), np.asarray(jo.state), atol=1e-5)
        js, ts = jo.state, to.state


@pytest.mark.parametrize("v_layers", [(48,), (32, 48)])
def test_per_row_forward_with_towers_of_different_shape_matches_jax(v_layers):
    """One weight set a row (the landscape's blends) with a value tower of
    other depth or widths: the layers the towers do not share in shape run
    each tower alone, and every row matches JAX's forward of its own blend."""
    B = 3
    anchors = []
    for k in jax.random.split(jax.random.PRNGKey(7), 2):
        ka, kb = jax.random.split(k)
        ja, jb = jlstm.init(ka, n_lstm=(48, 48)), jlstm.init(kb, n_lstm=v_layers)
        anchors.append(ja._replace(v_lstm=jb.v_lstm, vf_w=jb.vf_w, vf_b=jb.vf_b))
    w = np.array([[1.0, 0.0], [0.5, 0.5], [0.2, 0.8]], np.float32)
    jstack = jax.tree.map(lambda a, b: jnp.stack([wi[0] * a + wi[1] * b for wi in w]), *anchors)
    stacked = tls.blend_params([tio.policy_params_from_numpy(jax.tree.map(np.asarray, p),
                                                             device="cpu") for p in anchors], w)
    assert tlstm.per_row(stacked)
    rng = np.random.default_rng(12)
    S = 2 * (48 + 48) + 2 * sum(v_layers)
    obs = rng.normal(size=(B, 35)).astype(np.float32)
    state = (0.5 * rng.normal(size=(B, S))).astype(np.float32)
    done = np.array([0.0, 1.0, 0.0], np.float32)
    jo = jax.vmap(lambda p, o, s, d: jlstm.forward(p, o[None], s[None], d[None]))(
        jstack, jnp.asarray(obs), jnp.asarray(state), jnp.asarray(done))
    to = tlstm.forward(stacked, torch.from_numpy(obs), torch.from_numpy(state),
                       torch.from_numpy(done))
    np.testing.assert_allclose(to.mean.numpy(), np.asarray(jo.mean)[:, 0], atol=1e-5)
    np.testing.assert_allclose(to.value.numpy(), np.asarray(jo.value)[:, 0], atol=1e-5)
    np.testing.assert_allclose(to.state.numpy(), np.asarray(jo.state)[:, 0], atol=1e-5)


def test_loader_matches_jax_loader():
    jp = jax.tree.map(np.asarray, jio.load_bp5_csv(ARTIFACT))
    tp = tio.load_bp5_csv(ARTIFACT, device="cpu")
    carried = tio.policy_params_from_numpy(jp, device="cpu")
    for got in (tp, carried):
        for tw, jw in zip(got.pi_lstm + got.v_lstm, jp.pi_lstm + jp.v_lstm):
            for k in ("wx", "wh", "b"):
                np.testing.assert_array_equal(getattr(tw, k).numpy(), getattr(jw, k))
        for k in ("pi_w", "pi_b", "logstd", "vf_w", "vf_b"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(jp, k), err_msg=k)


def test_forward_and_action_match_jax_over_sequence():
    """20 steps of recurrent forward with a done in the middle."""
    B, T = 4, 20
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(T, B, 35)).astype(np.float32)
    done = np.zeros((T, B), np.float32)
    done[10, :2] = 1.0
    jp = jio.load_bp5_csv(ARTIFACT)
    tp = tio.load_bp5_csv(ARTIFACT, device="cpu")
    S = jlstm.state_size([48, 48])
    js, ts = jnp.zeros((B, S)), torch.zeros(B, S)
    for t in range(T):
        jo = jlstm.forward(jp, jnp.asarray(obs[t]), js, jnp.asarray(done[t]))
        ja, _ = jlstm.deterministic_action(jp, jnp.asarray(obs[t]), js, jnp.asarray(done[t]))
        to = tlstm.forward(tp, torch.from_numpy(obs[t]), ts, torch.from_numpy(done[t]))
        ta, ts2 = tlstm.deterministic_action(tp, torch.from_numpy(obs[t]), ts,
                                             torch.from_numpy(done[t]))
        # f32 products summed in another order, carried through 20 steps
        np.testing.assert_allclose(to.mean.numpy(), np.asarray(jo.mean), atol=1e-5)
        np.testing.assert_allclose(to.value.numpy(), np.asarray(jo.value), atol=1e-4)
        np.testing.assert_allclose(to.state.numpy(), np.asarray(jo.state), atol=1e-5)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
        assert torch.equal(ts2, to.state)
        js, ts = jo.state, to.state


@pytest.mark.parametrize("v_layers", [(16, 16), (16,), (8, 16)])
def test_sequence_matches_jax_with_dones_inside_the_window(v_layers):
    """The BPTT forward, layer by layer over the whole sequence, against the
    JAX package's scan over time of forward(): means, values and the final
    state, with resets inside the window and a non-zero initial state; with
    towers of one shape (the pair entry) and of different depth or width (the
    single-tower entry). Also against the port's own forward() stepped over
    time, which is what the rollout runs."""
    T, B = 12, 5
    ka, kb = jax.random.split(jax.random.PRNGKey(4))
    ja, jb = jlstm.init(ka, n_lstm=(16, 16)), jlstm.init(kb, n_lstm=v_layers)
    jp = ja._replace(v_lstm=jb.v_lstm, vf_w=jb.vf_w, vf_b=jb.vf_b)
    tp = tio.policy_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    S = 2 * 32 + 2 * sum(v_layers)
    rng = np.random.default_rng(21)
    obs = rng.normal(size=(T, B, 35)).astype(np.float32)
    done = (rng.random((T, B)) < 0.25).astype(np.float32)
    assert done[1:].sum() > 0
    state = (0.5 * rng.normal(size=(B, S))).astype(np.float32)
    want = jlstm.sequence(jp, jnp.asarray(obs), jnp.asarray(done), jnp.asarray(state))
    got = tlstm.sequence(tp, torch.from_numpy(obs), torch.from_numpy(done), torch.from_numpy(state))
    # a 12-step f32 recurrence, gate products summed in another order
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-5)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), atol=1e-5)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state), atol=1e-5)
    assert got.mean.shape == (T, B, 12) and got.value.shape == (T, B) and got.state.shape == (B, S)
    ts = torch.from_numpy(state)
    for t in range(T):
        step = tlstm.forward(tp, torch.from_numpy(obs[t]), ts, torch.from_numpy(done[t]))
        np.testing.assert_allclose(got.mean[t].numpy(), step.mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(got.value[t].numpy(), step.value.numpy(), atol=1e-6)
        ts = step.state
    np.testing.assert_allclose(got.state.numpy(), ts.numpy(), atol=1e-6)


def test_sequence_gradients_match_jax():
    """BPTT on the CPU (plain cells under autograd): the gradient of a loss
    on means, values and the final state with respect to every weight and to
    the initial state, against jax.grad through lstm.sequence."""
    T, B = 10, 4
    jp = jlstm.init(jax.random.PRNGKey(5), n_lstm=(16, 16))
    tp = tio.policy_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu").requires_grad_()
    rng = np.random.default_rng(22)
    obs = rng.normal(size=(T, B, 35)).astype(np.float32)
    done = (rng.random((T, B)) < 0.2).astype(np.float32)
    state = (0.5 * rng.normal(size=(B, 128))).astype(np.float32)
    tgt = rng.normal(size=(T, B, 12)).astype(np.float32)

    def jloss(p, s0):
        out = jlstm.sequence(p, jnp.asarray(obs), jnp.asarray(done), s0)
        return (jnp.mean((out.mean - tgt) ** 2) + jnp.mean(out.value ** 2)
                + jnp.mean(jnp.sin(out.state)))

    jg, jgs = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(state))
    s0 = torch.from_numpy(state).requires_grad_()
    out = tlstm.sequence(tp, torch.from_numpy(obs), torch.from_numpy(done), s0)
    (torch.mean((out.mean - torch.from_numpy(tgt)) ** 2) + torch.mean(out.value ** 2)
     + torch.mean(torch.sin(out.state))).backward()
    want = [np.asarray(x) for x in jax.tree.leaves(jg)]
    got = tp.leaves()
    assert len(got) == len(want) == 17
    for (name, g), w in zip(tp.named_leaves(), want):   # the JAX pytree's leaf order
        if name == "logstd":
            assert g.grad is None and not w.any()
            continue
        np.testing.assert_allclose(g.grad.numpy(), w, atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(s0.grad.numpy(), np.asarray(jgs), atol=1e-5, rtol=1e-4)


def test_raw_kernel_launches_refuse_tensors_that_require_grad():
    """The raw launch helpers return tensors without a grad_fn, so they raise
    on an input that requires grad while grad is enabled, before they touch
    the device; under no_grad, or with nothing to differentiate, the check
    passes."""
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="requires grad"):
        lstm_cuda._refuse_grad(x, None, w)
    lstm_cuda._refuse_grad(x, None, x)
    with torch.no_grad():
        lstm_cuda._refuse_grad(x, w)
    tw = tlstm.LSTMWeights(wx=torch.zeros(35, 64, requires_grad=True), wh=torch.zeros(16, 64),
                           b=torch.zeros(64))
    cpu = (torch.zeros(2, 35), torch.zeros(2, 16), torch.zeros(2, 16))
    with pytest.raises(RuntimeError, match="requires grad"):   # raised before any device work
        lstm_cuda._lstm_cell_kernel(tw, *cpu)
    with pytest.raises(RuntimeError, match="requires grad"):
        lstm_cuda._lstm_cell_pair_kernel(tw, tw, cpu[0], cpu[0], *cpu[1:], *cpu[1:], None)


def test_named_leaves_order():
    p = tlstm.init(torch.Generator().manual_seed(0), n_lstm=(16, 16), device="cpu")
    names = [k for k, _ in p.named_leaves()]
    assert names[:3] == ["pi_lstm.0.wx", "pi_lstm.0.wh", "pi_lstm.0.b"]
    assert names[6] == "v_lstm.0.wx" and names[-5:] == ["pi_w", "pi_b", "logstd", "vf_w", "vf_b"]
    assert not any(t.requires_grad for t in p.leaves())
    assert all(t.requires_grad for t in p.requires_grad_().leaves())
    assert p.leaves()[9] is p.v_lstm[1].wx and len(p.leaves()) == 17


def test_distribution_ops_match_jax():
    rng = np.random.default_rng(3)
    mean, action = (rng.normal(size=(6, 12)).astype(np.float32) for _ in range(2))
    logstd = (0.3 * rng.normal(size=12)).astype(np.float32)
    np.testing.assert_allclose(
        tlstm.neglogp(*(torch.from_numpy(x) for x in (mean, logstd, action))).numpy(),
        np.asarray(jlstm.neglogp(mean, logstd, action)), rtol=1e-6)
    np.testing.assert_allclose(tlstm.entropy(torch.from_numpy(logstd)).numpy(),
                               np.asarray(jlstm.entropy(logstd)), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    draws = tlstm.sample(gen, torch.zeros(20000, 12), torch.from_numpy(logstd))
    np.testing.assert_allclose(draws.std(0).numpy(), np.exp(logstd), rtol=0.05)


def test_init_shapes_and_orthogonality():
    p = tlstm.init(torch.Generator().manual_seed(0), device="cpu")
    assert p.pi_lstm[0].wx.shape == (35, 192) and p.v_lstm[1].wh.shape == (48, 192)
    wh = p.pi_lstm[0].wh
    torch.testing.assert_close(wh @ wh.T, torch.eye(48), atol=1e-5, rtol=0)
    assert p.pi_w.shape == (48, 12) and p.vf_w.shape == (48, 1)

