"""PyTorch port: each hand-written CUDA kernel against its plain version.

The kernels run only on a CUDA device (they have no CPU mode), so these tests
are marked ``cuda`` and skip without one. They import no JAX, so they also run
on a GPU machine without it: ``python -m pytest tests/test_torch_kernels.py``.
Tolerances of the single substep and the single cell are those the JAX
package holds its Pallas kernels to (test_phys_pallas.py:41-46,
test_ops.py:85-86). The fused control step is held by a chain: the single
substep strictly against the plain version; the fused kernel tightly against
8 x {plain PD torque + single-substep kernel} on the card (the same device
code, so only the torque's rounding differs); and loosely against its plain
loop, since 8 substeps of stiff penalty contact amplify rounding. The
control step's Convert2Torque inputs (torque feedforward, PD scale) are held
against the plain loop at the SRB closed loop's impulse scale, and leaving
them out must equal, bit for bit, a feedforward of 0 and a scale of 1.
"""

import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import lstm_cuda, pd_torque, phys_cuda
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import phys_lanes as lanes
from high_speed_quadrupedal_locomotion_by_irrl_torch.phys import model as mdl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _phys_inputs(B, seed, device):
    """Perturbed stand states (some toes in contact) and per-env randomized
    params, from numpy and a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    P = lanes.params_to_lanes(mdl.randomize(gen, config.train_default(), B, device))
    rng = np.random.default_rng(seed)
    gc = np.tile(mdl.stand_gc(0.0), (B, 1))
    gc[:, 2] = 0.30
    gc = gc + 0.05 * rng.normal(size=(B, 19))
    gc[:, 3:7] /= np.linalg.norm(gc[:, 3:7], axis=-1, keepdims=True)
    gv = 0.5 * rng.normal(size=(B, 18))
    tau = 5.0 * rng.normal(size=(B, 12))
    bw = np.concatenate([20.0 * rng.normal(size=(B, 3)), rng.normal(size=(B, 3))], -1)
    t = lambda x: torch.tensor(x.T, dtype=torch.float32, device=device).contiguous()  # noqa: E731
    return P, t(gc), t(gv), t(tau), t(bw)


@pytest.mark.parametrize("B", [1024, 37, 5])
@pytest.mark.parametrize("impulse_scale", [0.0, 400.0])
def test_phys_kernel_matches_plain(cuda, B, impulse_scale):
    cfg = config.test_default()
    P, gc, gv, tau, bw = _phys_inputs(B, B, cuda)
    args = (cfg.contact_slip_vel, impulse_scale, cfg.simulation_dt)
    want = lanes.substep(P, gc, gv, tau, bw, *args)
    before = phys_cuda.launches
    got = phys_cuda.substep(P, gc, gv, tau, bw, *args)
    torch.cuda.synchronize()
    assert phys_cuda.launches == before + 1
    assert (want[5] > 0).any(), "no toe in contact: the contact branch went untested"
    for i, atol in enumerate((1e-5, 1e-3, 1e-5, 1e-3)):   # gc, gv, toe, toe vel
        torch.testing.assert_close(got[i], want[i], atol=atol, rtol=0)
    for i in (4, 5):   # force norms: fp-association noise on multi-newton magnitudes
        torch.testing.assert_close(got[i], want[i], atol=5e-3, rtol=1e-4)


@pytest.mark.parametrize("B", [1024, 37, 5])
@pytest.mark.parametrize("d", [35, 48])
def test_lstm_kernel_matches_plain(cuda, B, d):
    g = torch.Generator(device=cuda).manual_seed(B + d)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    w = lstm.LSTMWeights(wx=r(d, 192, scale=0.2), wh=r(48, 192, scale=0.2), b=r(192, scale=0.1))
    x, c, h = r(B, d), r(B, 48), r(B, 48)
    before = lstm_cuda.launches
    got = lstm_cuda.lstm_cell(w, x, c, h)
    want = lstm.lstm_cell(w, x, c, h)
    torch.cuda.synchronize()
    assert lstm_cuda.launches == before + 1
    for a, b in zip(got, want):   # f32 gate products of length <= 96, another order
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _control_inputs(B, seed, device, motor_dynamics):
    """Substep inputs plus position targets around the stand pose, last
    normalized torques, and joint speeds fast enough to reach the motor
    envelope's speed-dependent part."""
    P, gc, gv, _, bw = _phys_inputs(B, seed, device)
    rng = np.random.default_rng(seed + 1)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device).contiguous()  # noqa: E731
    pt = t(mdl.stand_gc(0.0)[7:, None] + 0.3 * rng.normal(size=(12, B)))
    tnl = t(0.5 * rng.normal(size=(12, B)))
    gv = gv.clone()
    gv[6:] *= 30.0
    pd = pd_torque.from_config(config.test_default().replace(motor_dynamics=motor_dynamics))
    return P, pd, gc, gv, pt, tnl, bw


def _unfused_control_step(P, pd, gcT, gvT, ptT, tnlT, bwT, n, slip, imp, dt):
    """n x {plain PD torque -> single-substep kernel}."""
    for _ in range(n):
        tauT = pd_torque.pd_torque(pd, ptT.T, tnlT.T, gcT[7:].T, gvT[6:].T).T.contiguous()
        gcT, gvT, toe, toe_vel, fnorm, fn = phys_cuda.substep(P, gcT, gvT, tauT, bwT, slip, imp, dt)
    return gcT, gvT, toe, toe_vel, fnorm, fn, tauT


# (gc, gv, toe, toe vel, |f|, fn, torque): absolute, and relative for the forces
CHAIN_B_ATOL = (1e-5, 1e-3, 1e-5, 1e-3, 2e-2, 2e-2, 1e-3)    # fused vs unfused kernels
CHAIN_C_ATOL = (1e-5, 1e-2, 1e-5, 1e-2, 0.2, 0.2, 1e-2)      # fused vs plain loop


@pytest.mark.parametrize("B", [1024, 37, 5])
@pytest.mark.parametrize("n_substeps", [1, 8])
@pytest.mark.parametrize("motor_dynamics", [False, True])
def test_control_step_kernel_chain(cuda, B, n_substeps, motor_dynamics):
    cfg = config.test_default()
    args = _control_inputs(B, B + n_substeps, cuda, motor_dynamics)
    tail = (n_substeps, cfg.contact_slip_vel, 0.0, cfg.simulation_dt)
    before = phys_cuda.launches
    got = phys_cuda.control_step(*args, *tail)
    torch.cuda.synchronize()
    assert phys_cuda.launches == before + 1
    unfused = _unfused_control_step(*args, *tail)
    assert phys_cuda.launches == before + 1 + n_substeps
    plain = phys_cuda.control_step_plain(*args, *tail)
    assert (plain[5] > 0).any(), "no toe in contact: the contact branch went untested"
    # (b) the same device code behind both; the torque rounds otherwise in the kernel and
    # 8 stiff substeps carry that on (measured: 1.2e-2 N on forces of ~100 N, the rest
    # within the single-substep tolerances)
    for i, atol in enumerate(CHAIN_B_ATOL):
        torch.testing.assert_close(got[i], unfused[i], atol=atol, rtol=1e-4 if i in (4, 5) else 0)
    # (c) 8 stiff substeps amplify the single-substep differences (kn ~ 3e4 N/m turns
    # 1e-6 m into 0.03 N, and the state feeds back through the PD law); measured 3.4e-2 N,
    # 1.2e-3 on gv and 1.1e-3 Nm, held at some 6x that
    for i, atol in enumerate(CHAIN_C_ATOL):
        torch.testing.assert_close(got[i], plain[i], atol=atol, rtol=1e-3 if i in (4, 5) else 0)


def convert2torque_inputs(B, seed, device, which):
    """(tau_ffT, pd_scaleT) as (12, B) rows, or None where ``which`` leaves one
    out: stance-like feedforward torques of up to ~25 Nm and PD scales in
    [0, 1.5]."""
    rng = np.random.default_rng(seed + 2)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device).contiguous()  # noqa: E731
    ff = t(8.0 * rng.normal(size=(12, B))) if which in ("both", "tau_ff") else None
    ps = t(rng.uniform(0.0, 1.5, size=(12, B))) if which in ("both", "pd_scale") else None
    return ff, ps


@pytest.mark.parametrize("B", [1024, 5, 1])
@pytest.mark.parametrize("motor_dynamics", [False, True])
@pytest.mark.parametrize("which", ["both", "tau_ff", "pd_scale", "none"])
def test_control_step_convert2torque_matches_plain(cuda, B, motor_dynamics, which):
    """The Convert2Torque inputs at the closed loop's impulse scale
    (contact_impulse_mass 2.0 / simulation_dt), against the plain loop at the
    tolerances of chain (c)."""
    cfg = config.test_default()
    args = _control_inputs(B, B + 7, cuda, motor_dynamics)
    tail = (cfg.substeps, cfg.contact_slip_vel, 2.0 / cfg.simulation_dt, cfg.simulation_dt)
    ff, ps = convert2torque_inputs(B, B, cuda, which)
    before = phys_cuda.launches
    got = phys_cuda.control_step(*args, *tail, ff, ps)
    torch.cuda.synchronize()
    assert phys_cuda.launches == before + 1
    plain = phys_cuda.control_step_plain(*args, *tail, ff, ps)
    for i, atol in enumerate(CHAIN_C_ATOL):
        torch.testing.assert_close(got[i], plain[i], atol=atol, rtol=1e-3 if i in (4, 5) else 0)


@pytest.mark.parametrize("B", [1024, 5, 1])
@pytest.mark.parametrize("motor_dynamics", [False, True])
def test_control_step_null_inputs_are_the_pd_path(cuda, B, motor_dynamics):
    """Inputs left out compute, bit for bit, what tau_ff = 0 and pd_scale = 1
    compute (x 1 and + 0 are exact in f32)."""
    cfg = config.test_default()
    args = _control_inputs(B, B + 9, cuda, motor_dynamics)
    tail = (cfg.substeps, cfg.contact_slip_vel, 2.0 / cfg.simulation_dt, cfg.simulation_dt)
    zeros = torch.zeros(12, B, device=cuda)
    omitted = phys_cuda.control_step(*args, *tail)
    given = phys_cuda.control_step(*args, *tail, zeros, zeros + 1.0)
    torch.cuda.synchronize()
    for a, b in zip(omitted, given):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1024, 37, 5])
@pytest.mark.parametrize("d", [35, 48])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_pair_kernel_matches_plain(cuda, B, d, masked):
    """Both towers of a layer in one launch, reading strided views of a packed
    state, with the pre-cell reset mask."""
    g = torch.Generator(device=cuda).manual_seed(B + d)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    mk = lambda: lstm.LSTMWeights(wx=r(d, 192, scale=0.2), wh=r(48, 192, scale=0.2),  # noqa: E731
                                  b=r(192, scale=0.1))
    w0, w1, state, xs = mk(), mk(), r(B, 192), r(B, 2 * d + 3)
    mask = (torch.rand(B, generator=g, device=cuda) < 0.4).float() if masked else None
    args = (w0, w1, xs[:, :d], xs[:, d:2 * d], state[:, :48], state[:, 48:96],
            state[:, 96:144], state[:, 144:], mask)
    before = lstm_cuda.launches
    got = lstm_cuda.lstm_cell_pair(*args)
    want = lstm.lstm_cell_pair(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.launches == before + 1
    for a, b in zip(got, want):   # f32 gate products of length <= 96, another order
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _leaf(t):
    return t.detach().clone().requires_grad_()


def _layer_problem(B, d, towers, masked, T, device, seed, need_dx=True):
    """One layer of ``towers`` towers over T steps: leaf tensors for the
    weights, the inputs (views of one wider buffer; leaves only if
    ``need_dx``) and one packed initial state read through strided views, and
    a (T, B) mask."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=device)  # noqa: E731
    n = 48
    xs_all = r(T, B, towers * d)
    leaves = {"state": _leaf(r(B, 2 * n * towers + 5))}
    if need_dx:
        leaves["xs"] = _leaf(xs_all)
    for i in range(towers):
        leaves.update({f"wx{i}": _leaf(r(d, 4 * n, scale=0.2)), f"wh{i}": _leaf(r(n, 4 * n, scale=0.2)),
                       f"b{i}": _leaf(r(4 * n, scale=0.1))})
    mask = (torch.rand(T, B, generator=g, device=device) < 0.3).float() if masked else None
    weights = [(r(T, B, n), r(T, B, n)) for _ in range(towers)]   # of the scalar loss

    def run(layer_fn, lv, probes=None):
        # probes: a (B, 4n) zero leaf a tower, added to the bias of the plain cells, whose
        # gradient is that of the pre-activation gates row by row (summed over the steps)
        bias = lambda i: lv[f"b{i}"] if probes is None else lv[f"b{i}"] + probes[i]  # noqa: E731
        ws = [lstm.LSTMWeights(lv[f"wx{i}"], lv[f"wh{i}"], bias(i)) for i in range(towers)]
        x_all = lv["xs"] if need_dx else xs_all
        xs = [x_all[:, :, i * d:(i + 1) * d] for i in range(towers)]
        states = [(lv["state"][:, 2 * n * i:2 * n * i + n], lv["state"][:, 2 * n * i + n:2 * n * (i + 1)])
                  for i in range(towers)]
        out = layer_fn(ws, xs, mask, states)
        loss = sum((c * wc).sum() + (h * wh).sum() for (c, h), (wc, wh) in zip(out, weights))
        return out, loss
    return leaves, run


@pytest.mark.parametrize("B", [1024, 37, 5])
@pytest.mark.parametrize("d", [35, 48])
@pytest.mark.parametrize("towers,masked,T,need_dx", [
    (2, True, 1, True), (2, False, 1, True), (1, True, 1, True), (2, True, 4, True),
    (1, False, 3, True), (2, True, 4, False), (1, True, 1, False)])
def test_lstm_backward_kernel_matches_autograd(cuda, B, d, towers, masked, T, need_dx):
    """The training-mode forward and the backward kernel, through the autograd
    Function, against autograd of the plain cells: outputs, and the gradient
    of every input (dx, dc, dh through strided views of a packed state, dWx,
    dWh, db), with gradients arriving at every step's c' and h'. Without
    ``need_dx`` the inputs ask for no gradient, as a first layer's: the kernel
    then computes dh alone."""
    leaves, run = _layer_problem(B, d, towers, masked, T, cuda, seed=B + d + T, need_dx=need_dx)
    plain_leaves = {k: _leaf(v) for k, v in leaves.items()}
    before = (lstm_cuda.train_launches, lstm_cuda.bwd_launches)
    got, loss = run(lstm_cuda.lstm_layer_sequence, leaves)
    kept = got[0][0].grad_fn.gates   # the activated gates; the backward turns them into dgates
    loss.backward()
    probes = [torch.zeros(B, 192, device=cuda, requires_grad=True) for _ in range(towers)]
    want, loss_plain = run(lstm_cuda.lstm_layer_sequence_plain, plain_leaves, probes)
    loss_plain.backward()
    torch.cuda.synchronize()
    assert (lstm_cuda.train_launches, lstm_cuda.bwd_launches) == (before[0] + T, before[1] + T)
    for (c, h), (wc, wh) in zip(got, want):   # f32 gate products of length <= 96, another order
        torch.testing.assert_close(c, wc, atol=1e-5, rtol=0)
        torch.testing.assert_close(h, wh, atol=1e-5, rtol=0)
    for k in leaves:
        # sums over up to T * 1024 rows in another order: relative to the gradient's size
        scale = float(plain_leaves[k].grad.abs().max())
        torch.testing.assert_close(leaves[k].grad, plain_leaves[k].grad,
                                   atol=1e-5 + 1e-4 * scale, rtol=0, msg=lambda m, k=k: f"{k}: {m}")
    # dgates, which the kernel leaves where the gates were, row by row
    assert len(kept) == towers
    for i in range(towers):
        torch.testing.assert_close(kept[i].sum(0), probes[i].grad, rtol=0,
                                   atol=1e-5 + 1e-4 * float(probes[i].grad.abs().max()))


def test_lstm_layer_backward_runs_once(cuda):
    """The backward overwrites the kept gates: a second walk raises."""
    leaves, run = _layer_problem(5, 35, 2, True, 2, cuda, seed=0)
    _, loss = run(lstm_cuda.lstm_layer_sequence, leaves)
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="second time"):
        loss.backward()


def test_lstm_layer_refuses_dx_wider_than_n(cuda):
    """A backward thread owns at most one column of dx: an input wider than
    the layer that asks for a gradient is refused before any launch, by
    shape; the same input without a gradient runs."""
    g = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s: 0.2 * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    B, d, n = 5, 35, 16
    w = lstm.LSTMWeights(_leaf(r(d, 4 * n)), _leaf(r(n, 4 * n)), _leaf(r(4 * n)))
    state = (r(B, n), r(B, n))
    before = lstm_cuda.train_launches
    with pytest.raises(ValueError, match="d = 35, n = 16"):
        lstm_cuda.lstm_layer_sequence((w,), (_leaf(r(2, B, d)),), None, (state,))
    assert lstm_cuda.train_launches == before
    [(c, h)] = lstm_cuda.lstm_layer_sequence((w,), (r(2, B, d),), None, (state,))
    (c.sum() + h.sum()).backward()
    assert w.wx.grad is not None and lstm_cuda.train_launches == before + 2


def test_cell_wrappers_with_grad_match_plain(cuda):
    """lstm_cell and lstm_cell_pair given a tensor that requires grad go
    through the Function (one training-mode and one backward launch) and
    agree with the plain cells in value and gradient; without one they
    launch the inference kernel as before."""
    g = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=cuda)  # noqa: E731
    B, d = 37, 35
    base = dict(wx=r(d, 192, scale=0.2), wh=r(48, 192, scale=0.2), b=r(192, scale=0.1),
                x=r(B, d), c=r(B, 48), h=r(B, 48))
    grads = []
    for fn in (lstm_cuda.lstm_cell, lstm.lstm_cell):
        lv = {k: _leaf(v) for k, v in base.items()}
        before = (lstm_cuda.launches, lstm_cuda.train_launches, lstm_cuda.bwd_launches)
        c, h = fn(lstm.LSTMWeights(lv["wx"], lv["wh"], lv["b"]), lv["x"], lv["c"], lv["h"])
        (c.sin().sum() + h.cos().sum()).backward()
        if fn is lstm_cuda.lstm_cell:
            assert (lstm_cuda.launches, lstm_cuda.train_launches, lstm_cuda.bwd_launches) == (
                before[0], before[1] + 1, before[2] + 1)
        grads.append({k: v.grad for k, v in lv.items()})
    for k in base:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0,
                                   atol=1e-5 + 1e-4 * float(grads[1][k].abs().max()))
    w = lstm.LSTMWeights(base["wx"], base["wh"], base["b"])
    before = (lstm_cuda.launches, lstm_cuda.train_launches)
    lstm_cuda.lstm_cell(w, base["x"], base["c"], base["h"])
    assert (lstm_cuda.launches, lstm_cuda.train_launches) == (before[0] + 1, before[1])
    with pytest.raises(RuntimeError, match="requires grad"):
        lstm_cuda._lstm_cell_kernel(w, _leaf(base["x"]), base["c"], base["h"])


def test_sequence_bptt_through_kernels_matches_plain(cuda, monkeypatch):
    """models.lstm.sequence on the card: 2 training-mode and 2 backward pair
    launches a step, and the loss gradient of every parameter leaf agrees
    with the plain cells under autograd."""
    T, B = 6, 37
    g = torch.Generator(device=cuda).manual_seed(9)
    obs = torch.randn(T, B, 35, generator=g, device=cuda)
    done = (torch.rand(T, B, generator=g, device=cuda) < 0.2).float()
    state = torch.randn(B, 384, generator=g, device=cuda)
    tgt_m, tgt_v = torch.randn(T, B, 12, generator=g, device=cuda), torch.randn(T, B, generator=g, device=cuda)
    base = lstm.init(torch.Generator(device=cuda).manual_seed(1), device=cuda)
    results = []
    for plain in (False, True):
        p = mio.policy_params_from_numpy(mio.policy_params_to_numpy(base), cuda).requires_grad_()
        if plain:
            monkeypatch.setattr(lstm_cuda, "lstm_layer_sequence", lstm_cuda.lstm_layer_sequence_plain)
        before = (lstm_cuda.train_launches, lstm_cuda.bwd_launches)
        out = lstm.sequence(p, obs, done, state)
        loss = ((out.mean - tgt_m) ** 2).mean() + ((out.value - tgt_v) ** 2).mean() + out.state.sum()
        loss.backward()
        torch.cuda.synchronize()
        launched = (lstm_cuda.train_launches - before[0], lstm_cuda.bwd_launches - before[1])
        assert launched == ((0, 0) if plain else (2 * T, 2 * T))
        results.append((out, loss, p))
    (o0, l0, p0), (o1, l1, p1) = results
    torch.testing.assert_close(o0.mean, o1.mean, atol=1e-5, rtol=0)
    torch.testing.assert_close(o0.value, o1.value, atol=1e-5, rtol=0)
    torch.testing.assert_close(o0.state, o1.state, atol=1e-5, rtol=0)
    for (k, a), (_, b) in zip(p0.named_leaves(), p1.named_leaves()):
        if k == "logstd":
            assert a.grad is None and b.grad is None
            continue
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6 + 1e-4 * float(b.grad.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")


def test_policy_forward_launches_one_kernel_a_layer(cuda):
    p = lstm.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    before = lstm_cuda.launches
    out = lstm.forward(p, torch.zeros(7, 35, device=cuda), torch.zeros(7, 384, device=cuda),
                       torch.zeros(7, device=cuda))
    assert lstm_cuda.launches == before + len(p.pi_lstm)
    assert out.state.shape == (7, 384) and torch.isfinite(out.mean).all()


@pytest.mark.parametrize("v_layers,want_launches", [((48,), 2), ((32, 48), 4), ((48, 32, 32), 4)])
def test_policy_forward_with_unequal_towers(cuda, v_layers, want_launches):
    """Layers the towers share in shape take the pair launch; the others one
    single-cell launch a tower, with the state reset applied before it. Held
    against the same forward on the CPU (the plain versions)."""
    B = 37
    a = lstm.init(torch.Generator(device=cuda).manual_seed(1), device=cuda)
    b = lstm.init(torch.Generator(device=cuda).manual_seed(2), n_lstm=v_layers, device=cuda)
    p = lstm.PolicyParams(pi_lstm=a.pi_lstm, v_lstm=b.v_lstm, pi_w=a.pi_w, pi_b=a.pi_b,
                          logstd=a.logstd, vf_w=b.vf_w, vf_b=b.vf_b)
    cpu = lambda t: t.cpu()  # noqa: E731
    p_cpu = lstm.PolicyParams(
        pi_lstm=tuple(lstm.LSTMWeights(cpu(w.wx), cpu(w.wh), cpu(w.b)) for w in p.pi_lstm),
        v_lstm=tuple(lstm.LSTMWeights(cpu(w.wx), cpu(w.wh), cpu(w.b)) for w in p.v_lstm),
        pi_w=cpu(p.pi_w), pi_b=cpu(p.pi_b), logstd=cpu(p.logstd), vf_w=cpu(p.vf_w),
        vf_b=cpu(p.vf_b))
    g = torch.Generator().manual_seed(3)
    S = 2 * 96 + 2 * sum(v_layers)
    obs, state = torch.randn(B, 35, generator=g), torch.randn(B, S, generator=g)
    done = (torch.rand(B, generator=g) < 0.4).float()
    before = lstm_cuda.launches
    got = lstm.forward(p, obs.to(cuda), state.to(cuda), done.to(cuda))
    torch.cuda.synchronize()
    assert lstm_cuda.launches == before + want_launches
    want = lstm.forward(p_cpu, obs, state, done)
    for g_, w_ in zip(got[:3], want[:3]):   # f32 gate products summed in another order
        torch.testing.assert_close(g_.cpu(), w_, atol=1e-5, rtol=0)


def test_wrappers_refuse_bad_cuda_input(cuda):
    w = lstm.LSTMWeights(wx=torch.zeros(35, 192, device=cuda), wh=torch.zeros(48, 192, device=cuda),
                         b=torch.zeros(192, device=cuda))
    x = torch.zeros(4, 35, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_cell(w, torch.zeros(35, 4, device=cuda).T, torch.zeros(4, 48, device=cuda),
                            torch.zeros(4, 48, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        lstm_cuda.lstm_cell(w, x.double(), torch.zeros(4, 48, device=cuda),
                            torch.zeros(4, 48, device=cuda))
    P, gc, gv, tau, bw = _phys_inputs(4, 0, cuda)
    with pytest.raises(ValueError, match="shape"):
        phys_cuda.substep(P, gc, gv, tau[:11].contiguous(), bw, 0.1, 0.0, 2.5e-4)
    pd = pd_torque.from_config(config.test_default())
    z12 = torch.zeros(12, 4, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        phys_cuda.control_step(P, pd, gc, gv, z12[:11].contiguous(), z12, bw, 8, 0.1, 0.0, 2.5e-4)
    with pytest.raises(ValueError, match="float32"):
        phys_cuda.control_step(P, pd, gc, gv, z12.double(), z12, bw, 8, 0.1, 0.0, 2.5e-4)
    with pytest.raises(ValueError, match="contiguous"):
        phys_cuda.control_step(P, pd, gc, gv, torch.zeros(4, 12, device=cuda).T, z12, bw, 8,
                               0.1, 0.0, 2.5e-4)
    with pytest.raises(ValueError, match="n_substeps"):
        phys_cuda.control_step(P, pd, gc, gv, z12, z12, bw, 0, 0.1, 0.0, 2.5e-4)
    with pytest.raises(ValueError, match="tau_ffT.*shape"):
        phys_cuda.control_step(P, pd, gc, gv, z12, z12, bw, 8, 0.1, 0.0, 2.5e-4,
                               z12[:11].contiguous(), None)
    with pytest.raises(ValueError, match="pd_scaleT.*float32"):
        phys_cuda.control_step(P, pd, gc, gv, z12, z12, bw, 8, 0.1, 0.0, 2.5e-4, None,
                               z12.double())
    ch = torch.zeros(4, 48, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        lstm_cuda.lstm_cell_pair(w, w, x, x[:3], ch, ch, ch, ch)
    with pytest.raises(ValueError, match="float32"):
        lstm_cuda.lstm_cell_pair(w, w, x, x, ch.double(), ch, ch, ch)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_cell_pair(w, w, x, x, torch.zeros(48, 4, device=cuda).T, ch, ch, ch)
    with pytest.raises(ValueError, match="row stride"):
        lstm_cuda.lstm_cell_pair(w, w, x, x, ch, ch, torch.zeros(4, 96, device=cuda)[:, :48], ch)
