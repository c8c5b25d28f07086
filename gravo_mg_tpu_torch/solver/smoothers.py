"""Parallel smoothers (plain torch elementwise code around the SpMVs).

Counterpart of ``gravo_mg_tpu/solver/smoothers.py``: damped Jacobi and
Chebyshev-accelerated Jacobi stand in for the reference's serial
Gauss-Seidel (`gravomg/src/multigrid_solver.cpp:1194-1226`).
"""

from __future__ import annotations

from ..sparse import spmv


def jacobi(A, diag_inv, b, x, iters: int, omega: float = 2.0 / 3.0):
    """Damped Jacobi: x += omega * D^-1 (b - A x), ``iters`` times."""
    dinv = diag_inv[:, None] if b.ndim == 2 else diag_inv
    for _ in range(iters):
        x = x + omega * dinv * (b - spmv(A, x))
    return x


def chebyshev(A, diag_inv, b, x, degree: int, lam_min: float, lam_max: float):
    """Chebyshev polynomial smoother on D^-1 A over [lam_min, lam_max].

    Standard three-term recurrence (Saad, Iterative Methods, alg. 12.1);
    equivalent to ``degree`` optimally-weighted Jacobi sweeps targeting the
    high-frequency band.
    """
    dinv = diag_inv[:, None] if b.ndim == 2 else diag_inv
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = (1.0 / theta) * dinv * (b - spmv(A, x))
    x = x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = b - spmv(A, x)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * dinv * r
        x = x + d
        rho = rho_new
    return x
