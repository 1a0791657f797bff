"""Small SPD solves over a leading batch axis.

Port of ``ops/linalg.solve_spd``. The JAX package unrolls the Cholesky
factorization to scalar operations because batched 13x13 products waste the
TPU's matrix unit (``mpc/srb.py:297-303``); that trade does not carry over to
the GPU, so this is PyTorch's batched factorization and triangular solves.
The factorization reports failure through ``info`` instead of clamping the
pivots as the unrolled form does, and a failure raises
(:func:`check_factorized`: one check for all the factorizations of a solve).
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
