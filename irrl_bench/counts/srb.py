"""Operations of the convex SRB trot-MPC's solve, counted on the algorithm.

A frozen copy of ``chip_smoke.riccati_flops``: one knot of the dense affine
Riccati sweep and forward rollout (a multiply-add two): V A, V B, B'VB, B'VA,
B'v, the Cholesky factorization of Quu and its solve for the 1 + nx columns
of [qu | Qux], A'VA, Qux'K, A'v, Qux'k, the sums and the symmetrization; then
K x, A x and B f.
"""

NX, NU = 13, 12


def riccati_ops(nx: int = NX, nu: int = NU) -> int:
    products = 2 * (nx * nx * nx + nx * nx * nu + nu * nx * nu + nu * nx * nx + nu * nx
                    + nx * nx * nx + nx * nu * nx + nx * nx + nx * nu)
    chol = nu ** 3 // 3 + 2 * nu * nu * (1 + nx)
    sums = 4 * nx * nx + 3 * nx + 2 * nu * nu + nu
    forward = 2 * (nu * nx + nx * nx + nx * nu) + 3 * nx + 6 * 4
    return products + chol + sums + forward
