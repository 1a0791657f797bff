"""PyTorch port: the iLQR solvers against the JAX package, on toy problems.

``ilqr.solve`` on the LQR (exactly, and against the numpy Riccati optimum)
and the pendulum problems of ``tests/test_mpc.py``, with its ``relin_every``
and ``n_alphas`` options; ``ilqr.solve_batch`` on a batched pendulum with
every linearization (central FD, forward-mode AD, a ``linearize_b`` hook),
``relin_every`` 2, ``n_alphas`` 1 and 4 and a chunked horizon; the gains of an
indefinite ``Quu``; first-minimum ties and identical problems. All against
the JAX package live.

Tolerances, on cost traces and trajectories relative to their largest entry:
RTOL_AD for derivatives by AD or by hand (float32 rounding carried through
the iterations), RTOL_FD for central differences, whose 1 / (2 eps) turns an
ulp of the dynamics (another sin on each side) into ~5e-5 of a Jacobian entry.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch.mpc import ilqr as tilqr
from high_speed_quadrupedal_locomotion_by_irrl_tpu.mpc import ilqr as jilqr

torch.set_num_threads(1)

RTOL_AD, RTOL_FD = 2e-5, 1e-3


def _close(got, want, rtol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: max |err| {err:.3g} x {scale:.3g} > rtol {rtol}"


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


# --- ilqr.solve: tests/test_mpc.py's toys ------------------------------------------

LQR_DT, LQR_T = 0.1, 20
A_LQR = np.array([[1.0, LQR_DT], [0.0, 1.0]], np.float32)
B_LQR = np.array([[0.0], [LQR_DT]], np.float32)
R_LQR = 0.1


def _lqr_torch():
    A, Bm = _t(A_LQR), _t(B_LQR)
    dyn = lambda x, u, t: x @ A.T + u @ Bm.T  # noqa: E731
    cost = lambda x, u, t: (x * x).sum(-1) + R_LQR * (u * u).sum(-1)  # noqa: E731
    term = lambda x: 10.0 * (x * x).sum(-1)  # noqa: E731
    return dyn, cost, term


def _lqr_jax():
    A, Bm = jnp.asarray(A_LQR), jnp.asarray(B_LQR)
    Q, Rm = jnp.eye(2), jnp.eye(1) * R_LQR
    return (lambda x, u, t: A @ x + Bm @ u, lambda x, u, t: x @ Q @ x + u @ Rm @ u,
            lambda x: 10.0 * x @ x)


def test_solve_lqr_exactly_and_like_jax():
    """One iteration reaches the analytic finite-horizon LQR optimum; later
    iterations change (almost) nothing; the trace is JAX's."""
    res = tilqr.solve(*_lqr_torch(), _t([[1.0, 0.0]]), torch.zeros(1, LQR_T, 1), n_iter=3)
    P = 10.0 * np.eye(2)
    for _ in range(LQR_T):
        K = np.linalg.solve(R_LQR * np.eye(1) + B_LQR.T @ P @ B_LQR, B_LQR.T @ P @ A_LQR)
        P = np.eye(2) + A_LQR.T @ P @ (A_LQR - B_LQR @ K)
    opt = float(P[0, 0])
    assert res.cost.shape == (1,) and res.cost_trace.shape == (1, 3)
    np.testing.assert_allclose(float(res.cost[0]), opt, rtol=1e-2)
    assert abs(float(res.cost_trace[0, 1] - res.cost_trace[0, -1])) < 1e-4 * opt
    ref = jilqr.solve(*_lqr_jax(), jnp.array([1.0, 0.0]), jnp.zeros((LQR_T, 1)), n_iter=3)
    _close(res.cost_trace[0], ref.cost_trace, RTOL_AD, "cost trace")
    _close(res.us[0], ref.us, RTOL_AD, "us")
    _close(res.xs[0], ref.xs, RTOL_AD, "xs")


def _pendulum_torch(dt: float, semi_implicit: bool, w_th: float, w_u: float, w_term: float):
    def dyn(x, u, t):
        th, w = x[..., 0], x[..., 1]
        wdot = -9.81 * torch.sin(th) - 0.2 * w + u[..., 0]
        th2 = th + dt * (w + dt * wdot) if semi_implicit else th + dt * w
        return torch.stack([th2, w + dt * wdot], dim=-1)

    def cost(x, u, t):
        return (w_th * (x[..., 0] - math.pi) ** 2
                + (0.1 * x[..., 1] ** 2 if semi_implicit else 0.0) + w_u * u[..., 0] ** 2)

    def term(x):
        return w_term * (x[..., 0] - math.pi) ** 2 + 1.0 * x[..., 1] ** 2
    return dyn, cost, term


def _pendulum_jax(dt: float, semi_implicit: bool, w_th: float, w_u: float, w_term: float):
    def dyn(x, u, t):
        th, w = x
        wdot = -9.81 * jnp.sin(th) - 0.2 * w + u[0]
        th2 = th + dt * (w + dt * wdot) if semi_implicit else th + dt * w
        return jnp.array([th2, w + dt * wdot])

    def cost(x, u, t):
        return (w_th * (x[0] - jnp.pi) ** 2 + (0.1 * x[1] ** 2 if semi_implicit else 0.0)
                + w_u * u[0] ** 2)

    def term(x):
        return w_term * (x[0] - jnp.pi) ** 2 + 1.0 * x[1] ** 2
    return dyn, cost, term


def test_solve_pendulum_swing_stabilize_like_jax():
    """Damped pendulum driven to upright (x0 = [2.6, 0], 40 knots, 15
    iterations): near pi at the end, a non-increasing trace, and JAX's."""
    setup = (0.05, True, 5.0, 0.01, 50.0)
    res = tilqr.solve(*_pendulum_torch(*setup), _t([[2.6, 0.0]]), torch.zeros(1, 40, 1),
                      n_iter=15)
    assert abs(float(res.xs[0, -1, 0]) - math.pi) < 0.1
    assert (np.diff(res.cost_trace[0].numpy()) <= 1e-5).all()
    ref = jilqr.solve(*_pendulum_jax(*setup), jnp.array([2.6, 0.0]), jnp.zeros((40, 1)),
                      n_iter=15)
    _close(res.cost_trace[0], ref.cost_trace, RTOL_AD, "cost trace")
    _close(res.xs[0], ref.xs, RTOL_AD, "xs")


@pytest.mark.parametrize("relin_every,n_alphas,chunk", [(1, 8, 1), (2, 4, 1), (1, 1, 5)])
def test_solve_relin_and_alpha_options_like_jax(relin_every, n_alphas, chunk):
    """tests/test_mpc.py's options problem (pendulum from 0 to upright, 12
    iterations): full, Jacobian reuse with 4 step sizes, and a single step
    size over chunks of 5 knots, each against JAX with the same options."""
    setup = (0.05, False, 0.1, 0.01, 20.0)
    kw = dict(n_iter=12, relin_every=relin_every, n_alphas=n_alphas, linearize_chunk=chunk)
    res = tilqr.solve(*_pendulum_torch(*setup), torch.zeros(1, 2), torch.zeros(1, 40, 1), **kw)
    ref = jilqr.solve(*_pendulum_jax(*setup), jnp.zeros(2), jnp.zeros((40, 1)), **kw)
    _close(res.cost_trace[0], ref.cost_trace, RTOL_AD, "cost trace")
    _close(res.us[0], ref.us, RTOL_AD * 10, "us")
    if n_alphas > 1:
        assert abs(float(res.xs[0, -1, 0]) - math.pi) < 0.2


def test_solve_batches_problems_with_their_own_parameters():
    """B problems with per-problem dynamics constants (broadcast (B, 1) against
    the line search's (a, B)) give each problem's own single solve."""
    dt = 0.05
    g = _t([[9.81], [5.0], [12.0]])

    def dyn(x, u, t):
        th, w = x[..., 0], x[..., 1]
        wdot = -g[:, 0] * torch.sin(th) - 0.2 * w + u[..., 0]
        return torch.stack([th + dt * (w + dt * wdot), w + dt * wdot], dim=-1)
    _, cost, term = _pendulum_torch(dt, True, 5.0, 0.01, 50.0)
    x0 = _t([[2.6, 0.0], [2.0, 0.5], [3.0, -0.2]])
    res = tilqr.solve(dyn, cost, term, x0, torch.zeros(3, 30, 1), n_iter=6)
    for i in range(3):
        gi = float(g[i, 0])

        def dyn_i(x, u, t, gi=gi):
            th, w = x[..., 0], x[..., 1]
            wdot = -gi * torch.sin(th) - 0.2 * w + u[..., 0]
            return torch.stack([th + dt * (w + dt * wdot), w + dt * wdot], dim=-1)
        one = tilqr.solve(dyn_i, cost, term, x0[i:i + 1], torch.zeros(1, 30, 1), n_iter=6)
        _close(res.cost_trace[i], one.cost_trace[0], RTOL_AD, f"problem {i}")


# --- ilqr.solve_batch: a batched pendulum ---------------------------------------------

DT_B, T_B = 0.05, 20
X0_B = np.array([[2.6, 0.0], [2.0, 0.5], [3.0, -0.2]], np.float32)
TARGET_B = (math.pi + 0.1 * np.sin(np.arange(T_B) * 0.3)[None, :]
            * np.array([[1.0], [-1.0], [0.5]])).astype(np.float32)


def _batch_torch():
    def dyn_b(x, u):
        th, w = x[:, 0], x[:, 1]
        wdot = -9.81 * torch.sin(th) - 0.2 * w + u[:, 0]
        return torch.stack([th + DT_B * (w + DT_B * wdot), w + DT_B * wdot], dim=-1)

    def cost(x, u, arg):
        (target,) = arg
        return 5.0 * (x[..., 0] - target) ** 2 + 0.1 * x[..., 1] ** 2 + 0.01 * u[..., 0] ** 2

    def term(x, arg):
        (target,) = arg
        return 50.0 * (x[..., 0] - target) ** 2 + x[..., 1] ** 2

    def lin_b(X, U):
        c = -9.81 * torch.cos(X[:, 0])
        one, zero = torch.ones_like(c), torch.zeros_like(c)
        A = torch.stack([torch.stack([1.0 + DT_B * DT_B * c, DT_B + DT_B * DT_B * -0.2 * one], -1),
                         torch.stack([DT_B * c, 1.0 + DT_B * -0.2 * one], -1)], -2)
        Bm = torch.stack([DT_B * DT_B * one, DT_B * one + zero], -1)[..., None]
        return A, Bm
    return dyn_b, cost, term, lin_b


def _batch_jax():
    def dyn_b(x, u):
        th, w = x[:, 0], x[:, 1]
        wdot = -9.81 * jnp.sin(th) - 0.2 * w + u[:, 0]
        return jnp.stack([th + DT_B * (w + DT_B * wdot), w + DT_B * wdot], axis=-1)

    def cost(x, u, arg):
        (target,) = arg
        return 5.0 * (x[0] - target) ** 2 + 0.1 * x[1] ** 2 + 0.01 * u[0] ** 2

    def term(x, arg):
        (target,) = arg
        return 50.0 * (x[0] - target) ** 2 + x[1] ** 2

    def lin_b(X, U):
        c = -9.81 * jnp.cos(X[:, 0])
        one = jnp.ones_like(c)
        A = jnp.stack([jnp.stack([1.0 + DT_B * DT_B * c, DT_B + DT_B * DT_B * -0.2 * one], -1),
                       jnp.stack([DT_B * c, 1.0 + DT_B * -0.2 * one], -1)], -2)
        Bm = jnp.stack([DT_B * DT_B * one, DT_B * one], -1)[..., None]
        return A, Bm
    return dyn_b, cost, term, lin_b


@pytest.mark.parametrize("case", ["fd", "ad", "relin2", "alphas1", "alphas4", "hook", "chunk5"])
def test_solve_batch_matches_jax(case):
    kw = dict(n_iter=6, fd_eps=1e-3, relin_every=1, n_alphas=8, lin_chunk=0)
    kw.update({"ad": dict(fd_eps=0.0), "relin2": dict(relin_every=2),
               "alphas1": dict(n_alphas=1), "alphas4": dict(n_alphas=4, fd_eps=0.0),
               "chunk5": dict(lin_chunk=5)}.get(case, {}))
    dyn_t, cost_t, term_t, lin_t = _batch_torch()
    dyn_j, cost_j, term_j, lin_j = _batch_jax()
    u0 = np.zeros((3, T_B, 1), np.float32)
    res = tilqr.solve_batch(dyn_t, cost_t, term_t, _t(X0_B), _t(u0), (_t(TARGET_B),),
                            (_t(TARGET_B[:, -1]),), linearize_b=lin_t if case == "hook" else None,
                            **kw)
    ref = jilqr.solve_batch(dyn_j, cost_j, term_j, jnp.asarray(X0_B), jnp.asarray(u0),
                            (jnp.asarray(TARGET_B),), (jnp.asarray(TARGET_B[:, -1]),),
                            linearize_b=lin_j if case == "hook" else None, **kw)
    rtol = RTOL_FD if kw["fd_eps"] > 0 and case != "hook" else RTOL_AD
    assert res.cost_trace.shape == (3, 6)
    assert (res.cost_trace[:, -1] < res.cost_trace[:, 0]).all()
    _close(res.cost_trace, ref.cost_trace, rtol, "cost trace")
    _close(res.xs, ref.xs, rtol * 10, "xs")


def test_solve_batch_identical_problems_give_identical_results():
    """Repeats of a problem in the batch are bit for bit the same solve."""
    dyn_t, cost_t, term_t, _ = _batch_torch()
    x0 = _t(X0_B[[0, 1, 0, 1]])
    target = _t(TARGET_B[[0, 1, 0, 1]])
    res = tilqr.solve_batch(dyn_t, cost_t, term_t, x0, torch.zeros(4, T_B, 1), (target,),
                            (target[:, -1],), n_iter=4)
    assert torch.equal(res.us[0], res.us[2]) and torch.equal(res.us[1], res.us[3])
    assert torch.equal(res.cost_trace[0], res.cost_trace[2])


# --- gains and ties ----------------------------------------------------------------------

def test_gains_of_an_indefinite_quu_are_jaxs_clamped_gains():
    """An indefinite Quu (as early in a whole-body solve) gives the JAX
    package's huge clamped gains, not an exception."""
    rng = np.random.default_rng(0)
    m, n = 12, 37
    A = rng.normal(size=(m, m)).astype(np.float32)
    Quu = A @ A.T + np.eye(m, dtype=np.float32)
    Quu[-1, -1] -= 2.0 * Quu[-1, -1]     # the last pivot turns negative and is clamped
    assert np.linalg.eigvalsh(Quu).min() < 0
    Qu = rng.normal(size=m).astype(np.float32)
    Qux = rng.normal(size=(m, n)).astype(np.float32)
    k_j, K_j = jilqr._gains(jnp.asarray(Quu), jnp.asarray(Qu), jnp.asarray(Qux))
    k_t, K_t = tilqr._gains(_t(Quu)[None], _t(Qu)[None], _t(Qux)[None])
    assert np.abs(np.asarray(K_j)).max() > 1e5
    assert torch.isfinite(k_t).all() and torch.isfinite(K_t).all()
    _close(k_t[0], k_j, 1e-4, "k")
    _close(K_t[0], K_j, 1e-4, "K")


def test_first_argmin_breaks_ties_like_jnp_argmin():
    inf = float("inf")
    costs = torch.tensor([[3.0, inf, 1.0, 2.0], [1.0, inf, 1.0, 2.0], [1.0, inf, 0.5, 2.0]])
    want = np.asarray(jnp.argmin(jnp.asarray(costs.numpy()), axis=0))
    assert tilqr._first_argmin(costs).tolist() == want.tolist() == [1, 0, 2, 0]
