"""Small SPD solves over a leading batch axis.

Port of ``ops/linalg.py``. Two factorizations with different failure
semantics live here:

* :func:`solve_spd` is PyTorch's batched factorization and triangular solves.
  The factorization reports failure through ``info`` instead of clamping the
  pivots, and a failure raises (:func:`check_factorized`: one check for all
  the factorizations of a solve). The SRB solver uses it.
* :func:`cholesky_unrolled` keeps the JAX package's semantics: every pivot is
  clamped, ``L[j, j] = sqrt(max(s, 1e-12))``, so the factorization never
  fails. On an indefinite matrix it returns a factor of some other matrix and
  the solves give huge but finite values, which the iLQR's line search then
  rejects (``mpc/ilqr._gains``). :func:`solve_cholesky` and :func:`inv_spd`
  build on it. The JAX package unrolls the factorization to scalars for the
  TPU's vector unit; here it is a loop over the n <= 18 columns of batched
  tensors, and the substitutions are batched triangular solves.
"""

from __future__ import annotations

import torch


def check_factorized(info: torch.Tensor, what: str) -> None:
    """Raise if any factorization behind ``info`` failed (one sync)."""
    bad = int(torch.count_nonzero(info))
    if bad:
        raise torch.linalg.LinAlgError(
            f"{what}: {bad} of {info.numel()} matrices are not positive definite")


def solve_spd(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = M^-1 b for SPD M (..., n, n) and b (..., n, k); raises if M is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(M)
    check_factorized(info, "solve_spd")
    return torch.cholesky_solve(b, L)


def cholesky_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n) with clamped pivots (never fails).

    Column j: ``L[j, j] = sqrt(max(s, 1e-12))`` and ``L[i, j] = s_i / L[j, j]``
    (as ``s_i * (1 / L[j, j])``), where s and s_i are M[j, j] and M[i, j]
    less L[j, k] L[j, k] and L[i, k] L[j, k] for k = 0 .. j-1, subtracted in
    that order: the arithmetic of ``ops/linalg.cholesky_unrolled``, here as a
    right-looking update of the trailing block a column at a time. Built
    without in-place writes, so it also runs under ``torch.func`` transforms."""
    n = M.shape[-1]
    cols = []
    for j in range(n):
        # M is now the trailing (n-j, n-j) block
        d = torch.sqrt(torch.clamp_min(M[..., 0, 0], 1e-12))
        below = M[..., 1:, 0] * (1.0 / d)[..., None]
        cols.append(torch.nn.functional.pad(torch.cat([d[..., None], below], dim=-1), (j, 0)))
        M = M[..., 1:, 1:] - below[..., :, None] * below[..., None, :]
    return torch.stack(cols, dim=-1)


def solve_cholesky(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L L^T)^-1 b from a lower factor L (..., n, n); b (..., n, k)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def inv_spd(M: torch.Tensor) -> torch.Tensor:
    """M^-1 for SPD M (..., n, n): one clamped factorization, identity
    right-hand side (``ops/linalg.inv_spd``)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    return solve_cholesky(cholesky_unrolled(M), eye)
