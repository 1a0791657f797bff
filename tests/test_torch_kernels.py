"""PyTorch port: each hand-written CUDA kernel against its plain version.

The kernels run only on a CUDA device (they have no CPU mode), so these tests
are marked ``cuda`` and skip without one. They import no JAX, so they also run
on a GPU machine without it: ``python -m pytest tests/test_torch_kernels.py``.
Tolerances are those the JAX package holds its Pallas kernels to
(test_phys_pallas.py:41-46, test_ops.py:85-86).
"""

import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm
from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import lstm_cuda, phys_cuda
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
