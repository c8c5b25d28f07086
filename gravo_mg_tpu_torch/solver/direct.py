"""Direct and Krylov comparison solvers.

Counterpart of ``gravo_mg_tpu/solver/direct.py``: the reference's
solverType 0/1 (Eigen/Pardiso sparse factorizations,
multigrid_solver.cpp:1287-1366) as a host factorization (CHOLMOD when
scikit-sparse is importable, SuperLU otherwise), and solverType 4 (Eigen
CG, :1453-1477) as a Jacobi-preconditioned CG on the device whose operator
is the whole LHS in SlicedDiag or SlicedEll layout, so every iteration
launches the ``sliced_diag_spmv`` or ``sliced_spmv`` kernel on a GPU.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..sparse import (
    ell_from_scipy, numpy_dtype, resolve_device, sliced_layout_from_scipy, spmv,
)

# CG's operator falls back to transposed ELL when the SlicedEll layout
# would store beyond max(PAD_FACTOR nnz, PAD_FLOOR) entries (the transfer
# cap of MultigridSolveContext._build_transfer).
PAD_FACTOR = 24
PAD_FLOOR = 1 << 24
# The host reads CG's residual norm (a device sync) every CHECK_EVERY
# iterations only.
CHECK_EVERY = 32


def _cholmod_factor():
    """CHOLMOD's ``cholesky`` (scikit-sparse) if importable, else None."""
    try:
        from sksparse.cholmod import cholesky  # type: ignore
    except ImportError:
        return None
    return cholesky


def direct_solve(lhs_csr, rhs: np.ndarray, timing: Optional[dict] = None):
    """Host sparse direct factor + solve: CHOLMOD when available and the
    matrix is SPD, SuperLU otherwise."""
    cholesky = _cholmod_factor()
    t0 = time.perf_counter()
    solve_fn = None
    if cholesky is not None:
        try:
            solve_fn = cholesky(lhs_csr.tocsc())
            backend = "cholmod"
        except Exception:  # noqa: BLE001 — not SPD: SuperLU takes indefinite systems
            solve_fn = None
    if solve_fn is None:
        from scipy.sparse.linalg import splu

        solve_fn = splu(lhs_csr.tocsc()).solve
        backend = "superlu"
    t_factor = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    x = np.asarray(solve_fn(np.asarray(rhs)))
    t_solve = (time.perf_counter() - t0) * 1000
    if timing is not None:
        timing["direct_factor"] = t_factor
        timing["direct_solve"] = t_solve
        timing["direct_backend"] = backend
    return x


def cg_operator(lhs_csr, dtype=torch.float32):
    """The CG operator: SlicedDiag or SlicedEll, whichever streams fewer
    bytes per apply (the planner's rule, ``sparse.sliced_rule``),
    or transposed ELL where the sliced layout would store beyond
    ``max(PAD_FACTOR nnz, PAD_FLOOR)`` entries."""
    cap = max(PAD_FACTOR * lhs_csr.nnz, PAD_FLOOR)
    A = sliced_layout_from_scipy(lhs_csr, dtype=dtype, size_cap=cap)
    return A if A is not None else ell_from_scipy(lhs_csr, dtype=dtype)


def cg_solve(
    lhs_csr,
    rhs: np.ndarray,
    tol: float = 1e-4,
    max_iter: int = 10000,
    dtype=torch.float32,
    jacobi_precond: bool = True,
    device="cuda",
    timing: Optional[dict] = None,
):
    """Jacobi-preconditioned conjugate gradients on ``device`` (``"cuda"``
    by default, which raises without a GPU; ``"cpu"`` runs the plain
    PyTorch SpMV).

    Stops at ``||b - A x|| <= tol * ||b||`` or after exactly ``max_iter``
    iterations (one operator apply each).  For an (n, d) right-hand side
    the inner products run over the whole array, as in
    ``jax.scipy.sparse.linalg.cg``.  The host reads the recursive
    residual norm every ``CHECK_EVERY`` iterations only; when it meets
    tol, one more apply checks the true residual, which must meet tol too
    (otherwise the recursion restarts from it).  ``timing`` (optional)
    receives ``cg_iterations``, ``cg_residual`` (true relative residual
    of the returned iterate in compute dtype, or of the recursion when
    max_iter ran out) and ``cg_ms``.
    """
    device = resolve_device(device)
    A = cg_operator(lhs_csr.tocsr(), dtype).to(device)
    b = torch.from_numpy(np.ascontiguousarray(rhs, dtype=numpy_dtype(dtype)))
    b = b.to(device)
    dinv = 1.0 / np.maximum(np.asarray(lhs_csr.diagonal()), 1e-30)
    dinv = torch.from_numpy(dinv).to(device, dtype)
    if b.ndim == 2:
        dinv = dinv[:, None]

    def precond(v):
        return dinv * v if jacobi_precond else v

    t0 = time.perf_counter()
    x = torch.zeros_like(b)
    bnorm = float(torch.linalg.vector_norm(b))
    thresh2 = (tol * bnorm) ** 2
    iters = 0
    res = 0.0
    if bnorm > 0.0:
        r = b.clone()
        z = precond(r)
        p = z.clone()
        rz = torch.sum(r * z)
        while iters < max_iter:
            Ap = spmv(A, p)
            alpha = rz / torch.sum(p * Ap)
            x.addcmul_(p, alpha)
            r.addcmul_(Ap, alpha, value=-1.0)
            iters += 1
            if iters % CHECK_EVERY == 0 or iters == max_iter:
                rr = float(torch.sum(r * r))
                res = rr ** 0.5 / bnorm
                if rr <= thresh2:
                    r = b - spmv(A, x)
                    rr = float(torch.sum(r * r))
                    res = rr ** 0.5 / bnorm
                    if rr <= thresh2 or iters == max_iter:
                        break
                    # the recursion drifted: restart it from the true residual
                    z = precond(r)
                    p = z.clone()
                    rz = torch.sum(r * z)
                    continue
            z = precond(r)
            rz_new = torch.sum(r * z)
            p = z + (rz_new / rz) * p
            rz = rz_new
    if timing is not None:
        timing["cg_iterations"] = float(iters)
        timing["cg_residual"] = res
        timing["cg_ms"] = (time.perf_counter() - t0) * 1000
    return x.cpu().numpy()
