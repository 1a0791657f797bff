"""Batched iLQR trajectory optimizer.

Port of ``mpc/ilqr.py``. Where the JAX package writes one problem and
``vmap``s it, every tensor here has a leading problem axis: ``x0`` (B, n),
controls (B, T, m), the result's ``us`` (B, T, m), ``xs`` (B, T+1, n),
``cost`` (B,) and ``cost_trace`` (B, n_iter). The horizon and the iterations
are Python loops over batched tensors; JAX's ``lax.scan``/``lax.cond`` become
loops and a Python ``if`` on the iteration index.

Each iteration linearizes the dynamics (chunks of knots at a time), takes the
cost's derivatives over the whole horizon at once, runs the backward Riccati
recursion with Levenberg-Marquardt regularization (``lam``, per problem), and
rolls out ``n_alphas`` step sizes 1, 1/2, ... in parallel, keeping the first
cheapest one if it lowers the cost (non-finite costs count as infinite).

Derivatives use ``torch.func``: the cost's per-sample gradient and Hessian
(forward over reverse), and the dynamics' Jacobian by forward mode. Samples
are independent, so one ``jvp`` over n + m copies of the samples, copy i
pushing basis direction i, gives column i of every sample's Jacobian (what
``vmap`` over the directions computes, in one pass of plain batched ops).
Gains come from the clamped factorization of ``ops/linalg.cholesky_unrolled``:
an indefinite ``Quu`` gives huge gains and a rejected step, as in the JAX
package, never an exception.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import func as tfunc

from high_speed_quadrupedal_locomotion_by_irrl_torch.ops import linalg


def _gains(Quu: torch.Tensor, Qu: torch.Tensor, Qux: torch.Tensor):
    """(k, K) = -Quu^-1 [Qu | Qux] via one clamped factorization of
    Quu + 1e-9 I. Quu (..., m, m), Qu (..., m), Qux (..., m, n)."""
    m = Qu.shape[-1]
    rhs = torch.cat([Qu[..., None], Qux], dim=-1)          # (..., m, 1+n)
    eye = torch.eye(m, dtype=Quu.dtype, device=Quu.device)
    sol = linalg.solve_cholesky(linalg.cholesky_unrolled(Quu + 1e-9 * eye), rhs)
    return -sol[..., 0], -sol[..., 1:]


class ILQRResult(NamedTuple):
    us: torch.Tensor          # (B, T, m) optimized controls
    xs: torch.Tensor          # (B, T+1, n) optimized trajectory
    cost: torch.Tensor        # (B,) final total cost
    cost_trace: torch.Tensor  # (B, n_iter) cost after each iteration


def _directions(X: torch.Tensor, U: torch.Tensor):
    """The n + m basis directions of (x, u), one a copy of every sample:
    primals (n+m, ..., n), (n+m, ..., m) and one-hot tangents alike."""
    n, m = X.shape[-1], U.shape[-1]
    eye = torch.eye(n + m, dtype=X.dtype, device=X.device)
    lead = (n + m,) + (1,) * (X.dim() - 1)
    rep = lambda x, shape: x.expand((n + m,) + tuple(shape)).contiguous()  # noqa: E731
    return ((rep(X, X.shape), rep(U, U.shape)),
            (rep(eye[:, :n].reshape(lead + (n,)), X.shape),
             rep(eye[:, n:].reshape(lead + (m,)), U.shape)))


def jacobian(f: Callable, X: torch.Tensor, U: torch.Tensor):
    """Per-sample (A (..., n, n), B (..., n, m)) of f: (..., n), (..., m) ->
    (..., n) whose samples are independent, by forward mode: one
    ``torch.func.jvp`` over n + m copies of the samples, each copy pushing
    one basis direction (``jax.jacfwd``'s columns without a ``vmap``). f must
    take the extra leading dim."""
    n = X.shape[-1]
    J = torch.movedim(tfunc.jvp(f, *_directions(X, U))[1], 0, -1)
    return J[..., :n], J[..., n:]


def _quadratize(cost: Callable, X: torch.Tensor, U: torch.Tensor):
    """Per-sample derivatives of cost: (..., n), (..., m) -> (...):
    cx (..., n), cu (..., m), cxx (..., n, n), cuu (..., m, m), cux (..., m, n),
    the Hessian blocks by forward mode over the gradient."""
    n = X.shape[-1]
    grad = tfunc.grad(lambda x, u: cost(x, u).sum(), argnums=(0, 1))
    cx, cu = grad(X, U)
    hx, hu = tfunc.jvp(grad, *_directions(X, U))[1]          # d(cx, cu) / d z_i
    return (cx, cu, torch.movedim(hx[:n], 0, -1), torch.movedim(hu[n:], 0, -1),
            torch.movedim(hu[:n], 0, -1))


def _quadratize_terminal(cost: Callable, X: torch.Tensor):
    """vx (..., n), vxx (..., n, n) of a per-sample cost (..., n) -> (...)."""
    n = X.shape[-1]
    grad = tfunc.grad(lambda x: cost(x).sum())
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    shape = (n,) + tuple(X.shape)
    tangent = eye.reshape((n,) + (1,) * (X.dim() - 1) + (n,)).expand(shape).contiguous()
    hx = tfunc.jvp(grad, (X.expand(shape).contiguous(),), (tangent,))[1]
    return grad(X), torch.movedim(hx, 0, -1)


def _backward(A, Bm, cx, cu, cxx, cuu, cux, vx, vxx, lam):
    """Riccati recursion over T knots of (B, T, ...) derivatives -> gains
    ks (B, T, m), Ks (B, T, m, n)."""
    T, m = A.shape[1], Bm.shape[-1]
    reg = lam[:, None, None] * torch.eye(m, dtype=A.dtype, device=A.device)
    Vx, Vxx = vx, vxx
    ks, Ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        A_t, B_t = A[:, t], Bm[:, t]
        At, Bt = A_t.transpose(-1, -2), B_t.transpose(-1, -2)
        BtV = Bt @ Vxx
        Qx = cx[:, t] + (At @ Vx[..., None])[..., 0]
        Qu = cu[:, t] + (Bt @ Vx[..., None])[..., 0]
        Qxx = cxx[:, t] + At @ Vxx @ A_t
        Quu = cuu[:, t] + BtV @ B_t + reg
        Qux = cux[:, t] + BtV @ A_t
        k, K = _gains(Quu, Qu, Qux)
        Kt, Quxt = K.transpose(-1, -2), Qux.transpose(-1, -2)
        Vx = (Qx + (Kt @ Quu @ k[..., None])[..., 0] + (Kt @ Qu[..., None])[..., 0]
              + (Quxt @ k[..., None])[..., 0])
        Vxx = Qxx + Kt @ Quu @ K + Kt @ Qux + Quxt @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        ks[t], Ks[t] = k, K
    return torch.stack(ks, dim=1), torch.stack(Ks, dim=1)


def _first_argmin(costs: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 0 (``jnp.argmin``'s tie rule)."""
    n = costs.shape[0]
    idx = torch.arange(n, device=costs.device).reshape((n,) + (1,) * (costs.dim() - 1))
    low = costs.min(dim=0, keepdim=True).values
    return torch.where(costs == low, idx, n).min(dim=0).values


def _accept(us_c, xs_c, costs, us, xs, best_cost, lam):
    """Pick each problem's best step size of (a, B, ...) candidates; keep it
    if it lowers the cost, and adapt lam. Returns (us, xs, cost, lam)."""
    costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, float("inf")))
    best = _first_argmin(costs)                              # (B,)
    rows = torch.arange(costs.shape[1], device=costs.device)
    bcost = costs[best, rows]
    improved = bcost < best_cost
    pick = lambda w, old: torch.where(improved[:, None, None], w[best, rows], old)  # noqa: E731
    lam = torch.where(improved, torch.clamp_min(lam * 0.5, 1e-8), lam * 10.0)
    return pick(us_c, us), pick(xs_c, xs), torch.where(improved, bcost, best_cost), lam


def _trace(trace: list, cost: torch.Tensor) -> torch.Tensor:
    """(B, n_iter) from the iterations' costs; (B, 0) for no iteration (the
    warm start's cost alone)."""
    return torch.stack(trace, dim=1) if trace else cost[:, None][:, :0]


class Replayed:
    """``fn`` on CUDA tensors run as a CUDA graph: captured at the first call
    with each set of input shapes, then replayed with the inputs copied in and
    the outputs copied out (the next replay overwrites the graph's own). A
    linearizer is called T / chunk times an iteration at one shape, and each
    call is thousands of small PyTorch ops (forward-mode AD through a model
    step) that the host would otherwise issue again. What ``fn`` reads besides
    its arguments (a robot, a terrain, constants) must not change between
    calls. The graphs live as long as the object: a receding-horizon loop
    wraps its linearizer once and hands the same object to every solve, so
    it captures once a shape and rollout. CPU tensors run ``fn`` itself."""

    def __init__(self, fn: Callable):
        self.fn, self.graphs = fn, {}

    def __call__(self, *args):
        if not args[0].is_cuda:
            return self.fn(*args)
        key = tuple(a.shape for a in args)
        if key not in self.graphs:
            static = [a.clone() for a in args]
            stream = torch.cuda.current_stream(args[0].device)
            side = torch.cuda.Stream(device=args[0].device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self.fn(*static)          # warm-up: lazy state is created outside the capture
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.fn(*static)
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        return tuple(o.clone() for o in out)


def _rollout(dynamics: Callable, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """(B, T+1, n) states of (B, T, m) controls from x0 (B, n)."""
    ts = torch.arange(us.shape[1], device=x0.device)
    xs = [x0]
    for t in range(us.shape[1]):
        xs.append(dynamics(xs[-1], us[:, t], ts[t]))
    return torch.stack(xs, dim=1)


def _total_cost(cost_fn: Callable, term_cost_fn: Callable, xs: torch.Tensor,
                us: torch.Tensor) -> torch.Tensor:
    """(..., B): the stage costs of (..., B, T+1, n) states and (..., B, T, m)
    controls summed over the horizon, plus the terminal cost."""
    ts = torch.arange(us.shape[-2], device=xs.device)
    return cost_fn(xs[..., :-1, :], us, ts).sum(-1) + term_cost_fn(xs[..., -1, :])


def _linearize(dynamics: Callable, linearize_fn, xs: torch.Tensor, us: torch.Tensor,
               chunk: int):
    """(A (B, T, n, n), B (B, T, n, m)) by blocks of ``chunk`` knots, (C, B, ...)
    each: ``linearize_fn`` or forward-mode AD through ``dynamics``."""
    T = us.shape[1]
    ts = torch.arange(T, device=xs.device)
    As, Bs = [], []
    for c0 in range(0, T, chunk):
        X, U = xs[:, c0:c0 + chunk].transpose(0, 1), us[:, c0:c0 + chunk].transpose(0, 1)
        if linearize_fn is not None:
            A_c, B_c = linearize_fn(X, U)
        else:
            t_c = ts[c0:c0 + chunk, None]
            A_c, B_c = jacobian(lambda x, u: dynamics(x, u, t_c), X, U)
        As.append(A_c)
        Bs.append(B_c)
    return torch.cat(As).transpose(0, 1), torch.cat(Bs).transpose(0, 1)


def _line_search(dynamics: Callable, x0, us, xs, ks, Ks, alphas):
    """All step sizes at once: (a, B, T, m) controls and (a, B, T+1, n) states
    of u = u_ref + alpha k + K (x - x_ref) rolled out from x0."""
    ts = torch.arange(us.shape[1], device=x0.device)
    x = x0.expand((alphas.shape[0],) + x0.shape)
    us_c, xs_c = [], [x]
    for t in range(us.shape[1]):
        u = us[:, t] + alphas * ks[:, t] + (Ks[:, t] @ (x - xs[:, t])[..., None])[..., 0]
        x = dynamics(x, u, ts[t])
        us_c.append(u)
        xs_c.append(x)
    return torch.stack(us_c, dim=2), torch.stack(xs_c, dim=2)


def solve(dynamics: Callable, cost_fn: Callable, term_cost_fn: Callable,
          x0: torch.Tensor, u_init: torch.Tensor, n_iter: int = 10,
          reg: float = 1e-6, linearize_chunk: int = 1,
          n_alphas: int = 8, relin_every: int = 1,
          linearize_fn: Callable | None = None) -> ILQRResult:
    """Minimize sum_t cost(x_t, u_t, t) + term(x_T) s.t. x_{t+1} = dynamics(x_t, u_t, t)
    for each of B problems. x0 (B, n), u_init (B, T, m).

    dynamics: x (..., B, n), u (..., B, m), t -> (..., B, n), where t is an
    int64 tensor of knot indices that broadcasts against the leading dims
    (a 0-dim tensor in rollouts, (C, 1) for a chunk of C knots);
    cost_fn: x (..., B, T, n), u (..., B, T, m), t (T,) -> (..., B, T);
    term_cost_fn: x (..., B, n) -> (..., B). Samples must be independent.

    linearize_chunk: knots linearized at a time (a memory bound; the JAX
    package scans over T / chunk blocks). n_alphas: step sizes 1..2^-(n_alphas-1).
    relin_every: recompute the dynamics Jacobians only on iterations
    i % relin_every == 0. linearize_fn: optional Jacobian provider
    ``(X (C, B, n), U (C, B, m)) -> (A (C, B, n, n), B (C, B, n, m))`` in place
    of forward-mode AD through ``dynamics`` (e.g. the frozen-operator
    surrogate of :mod:`.linearize`; time-invariant dynamics only); on the card
    it is replayed from a CUDA graph: a :class:`Replayed` is used as given
    (its graphs kept across solves), any other provider is wrapped in a new
    one for this solve."""
    lin = linearize_fn
    if lin is not None and not isinstance(lin, Replayed):
        lin = Replayed(lin)
    return _solve(dynamics, cost_fn, term_cost_fn, x0, u_init, n_iter, reg, linearize_chunk,
                  n_alphas, relin_every, lin)


def _solve(dynamics, cost_fn, term_cost_fn, x0, u_init, n_iter, reg, chunk, n_alphas,
           relin_every, lin) -> ILQRResult:
    """The iterations of :func:`solve`, with ``lin`` the Jacobian provider as
    it is called (None: forward-mode AD through ``dynamics``)."""
    B, T, m = u_init.shape
    if T % chunk:
        raise ValueError(f"ilqr.solve: horizon {T} is not a multiple of linearize_chunk {chunk}")
    alphas = (0.5 ** torch.arange(n_alphas, dtype=x0.dtype, device=x0.device))[:, None, None]
    ts = torch.arange(T, device=x0.device)
    stage = lambda x, u: cost_fn(x, u, ts)  # noqa: E731

    us, xs = u_init, _rollout(dynamics, x0, u_init)
    cost = _total_cost(cost_fn, term_cost_fn, xs, us)
    lam = torch.full((B,), reg, dtype=x0.dtype, device=x0.device)
    trace = []
    for it in range(n_iter):
        if it % relin_every == 0:
            A, Bm = _linearize(dynamics, lin, xs, us, chunk)   # (B,T,n,n), (B,T,n,m)
        quad = _quadratize(stage, xs[:, :-1], us)
        ks, Ks = _backward(A, Bm, *quad, *_quadratize_terminal(term_cost_fn, xs[:, -1]), lam)
        us_c, xs_c = _line_search(dynamics, x0, us, xs, ks, Ks, alphas)
        costs = _total_cost(cost_fn, term_cost_fn, xs_c, us_c)
        us, xs, cost, lam = _accept(us_c, xs_c, costs, us, xs, cost, lam)
        trace.append(cost)
    return ILQRResult(us=us, xs=xs, cost=cost, cost_trace=_trace(trace, cost))


def _jacobian_fd(dynamics_b: Callable, X: torch.Tensor, U: torch.Tensor, eps: float):
    """Central differences (A (K, n, n), B (K, n, m)): the plus and the minus
    perturbation of all n + m directions ride ONE call of dynamics_b,
    2 (n+m) K lanes wide."""
    K, n = X.shape
    m = U.shape[-1]
    eye = torch.eye(n + m, dtype=X.dtype, device=X.device)
    d = torch.cat([eps * eye, -eps * eye])                 # (2(n+m), n+m)
    F = dynamics_b((X[None] + d[:, None, :n]).reshape(-1, n),
                   (U[None] + d[:, None, n:]).reshape(-1, m)).reshape(2, n + m, K, n)
    J = ((F[0] - F[1]) / (2.0 * eps)).permute(1, 2, 0)     # (K, n, n+m)
    return J[..., :n], J[..., n:]


def solve_batch(dynamics_b: Callable, cost_fn: Callable, term_cost_fn: Callable,
                x0s: torch.Tensor, u_inits: torch.Tensor,
                stage_args, term_args, n_iter: int = 8, reg: float = 1e-6,
                lin_chunk: int = 0, n_alphas: int = 8,
                relin_every: int = 1, fd_eps: float = 1e-3,
                linearize_b: Callable | None = None) -> ILQRResult:
    """Batched iLQR where the dynamics is one call over a flat batch:
    ``dynamics_b: (K, n), (K, m) -> (K, n)`` (e.g. the batch-in-lanes physics
    of ``trot.make_dynamics_batch``). It runs :func:`solve`'s iterations,
    whose leading dims (step sizes, directions, knots, problems) ride
    ``dynamics_b``'s one flat axis, so each stage feeds it the widest batch
    it has:

    - linearization: by central finite differences (``fd_eps > 0``: all
      2 (n+m) perturbations of the B x C knots of a chunk in one call,
      K = 2 (n+m) C B), by forward-mode AD (``fd_eps = 0``; dynamics_b must
      then be differentiable PyTorch), or by ``linearize_b``
      ``(X (K, n), U (K, m)) -> (A (K, n, n), B (K, n, m))`` in their place
      (replayed from a CUDA graph on the card, as in :func:`solve`);
    - line search: all step sizes of all problems, K = n_alphas B;
    - rollouts: K = B.

    cost_fn: x (..., n), u (..., m), stage_args -> (...), where the leaves of
    ``stage_args`` are (B, T, ...) and broadcast against x's leading dims;
    term_cost_fn: x (..., n), term_args -> (...), leaves (B, ...).
    lin_chunk: knots linearized per call (0 = the whole horizon).
    Calls of dynamics_b a solve: (1 + n_iter) T for the rollout and the line
    searches, plus T / lin_chunk on each iteration that linearizes by FD."""
    T, m = u_inits.shape[1:]
    n = x0s.shape[-1]

    def dynamics(x, u, t):
        del t
        return dynamics_b(x.reshape(-1, n), u.reshape(-1, m)).reshape(x.shape)

    flat = None
    if linearize_b is not None:
        flat = Replayed(linearize_b)
    elif fd_eps > 0.0:
        flat = lambda X, U: _jacobian_fd(dynamics_b, X, U, fd_eps)  # noqa: E731

    def lin(X, U):          # (C, B, ...) knot-major blocks <-> dynamics_b's flat lanes
        A, Bm = flat(X.reshape(-1, n), U.reshape(-1, m))
        return A.reshape(X.shape + (n,)), Bm.reshape(X.shape + (m,))

    return _solve(dynamics, lambda x, u, ts: cost_fn(x, u, stage_args),
                  lambda x: term_cost_fn(x, term_args), x0s, u_inits, n_iter, reg,
                  T if lin_chunk == 0 else lin_chunk, n_alphas, relin_every,
                  None if flat is None else lin)
