"""Parallel smoothers.

Counterpart of ``gravo_mg_tpu/solver/smoothers.py``: damped Jacobi and
Chebyshev-accelerated Jacobi stand in for the reference's serial
Gauss-Seidel (`gravomg/src/multigrid_solver.cpp:1194-1226`).  Each step
is one :func:`sparse.cheb_step`: on the card's sliced layouts one SpMV
launch whose epilogue forms the residual, the step and the new iterate
(where the JAX package has its Pallas SpMV and an XLA fusion around it),
elsewhere the same torch ops after the SpMV.
"""

from __future__ import annotations

from ..sparse import cheb_step


def jacobi(A, diag_inv, b, x, iters: int, omega: float = 2.0 / 3.0):
    """Damped Jacobi: x += omega * D^-1 (b - A x), ``iters`` times."""
    for _ in range(iters):
        x, _ = cheb_step(A, diag_inv, b, x, None, None, omega, keep_d=False)
    return x


def chebyshev(A, diag_inv, b, x, degree: int, lam_min: float, lam_max: float):
    """Chebyshev polynomial smoother on D^-1 A over [lam_min, lam_max].

    Standard three-term recurrence (Saad, Iterative Methods, alg. 12.1);
    equivalent to ``degree`` optimally-weighted Jacobi sweeps targeting the
    high-frequency band.
    """
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    x, d = cheb_step(A, diag_inv, b, x, None, None, 1.0 / theta,
                     keep_d=degree > 1)
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        x, d = cheb_step(A, diag_inv, b, x, d, rho_new * rho, 2.0 * rho_new / delta)
        rho = rho_new
    return x
