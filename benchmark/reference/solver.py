"""The control: the reference put in the program's place, in a lower
precision than the configuration states.

``ReferenceSolver`` is Jacobi-preconditioned CG in plain torch, every
operation in its ``dtype``; it reports the residual it stopped at, worked
out in that dtype, as the program does.  ``ReferenceFlow`` is the cMCF step
with each stage's result held in the lower precision and its solve done by
``ReferenceSolver``.  Both have the attributes the harness drives
(``solve``/``solver_timing``; ``step``/``V``/``solver``).  Nothing of the
program is imported here.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .mesh import cotan_laplacian, mass_barycentric, normalize_area


def _csr_to_torch(A, dtype, device):
    A = A.tocoo()
    row = torch.from_numpy(A.row.astype(np.int64)).to(device)
    col = torch.from_numpy(A.col.astype(np.int64)).to(device)
    val = torch.from_numpy(A.data.astype(np.float64)).to(device, dtype)
    return row, col, val, A.shape[0]


def _spmv(op, x):
    row, col, val, n = op
    y = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, row, val[:, None] * x[col])


class ReferenceSolver:
    """Jacobi-PCG to the criterion-2 residual ``tolerance``, in ``dtype``."""

    def __init__(self, mass, dtype, device, tolerance=1e-4, max_iter=5000):
        self.mass = mass.tocsr()
        self.dtype = dtype
        self.device = torch.device(device)
        self.tolerance = float(tolerance)
        self.max_iter = int(max_iter)
        self.solver_timing: dict = {}

    def solve(self, lhs, rhs, x0=None, mode="traced"):
        t0 = time.perf_counter()
        dt, dev = self.dtype, self.device
        A = _csr_to_torch(lhs, dt, dev)
        M = _csr_to_torch(self.mass, dt, dev)
        rhs = np.asarray(rhs, dtype=np.float64)
        squeeze = rhs.ndim == 1
        b = torch.from_numpy(rhs.reshape(rhs.shape[0], -1)).to(dev, dt)
        dinv = 1.0 / torch.from_numpy(lhs.diagonal()).to(dev, dt)

        def criterion(r):
            return torch.max(torch.sqrt(torch.sum(r * _spmv(M, r), 0)) / den)

        den = torch.sqrt(torch.sum(b * _spmv(M, b), 0))
        x = torch.zeros_like(b)
        r = b.clone()
        z = dinv[:, None] * r
        p = z.clone()
        rz = torch.sum(r * z, 0)
        it = 0
        while it < self.max_iter:
            Ap = _spmv(A, p)
            alpha = rz / torch.sum(p * Ap, 0)
            x = x + alpha * p
            r = r - alpha * Ap
            it += 1
            if it % 10 == 0 and float(criterion(r)) <= self.tolerance:
                break
            z = dinv[:, None] * r
            rz_new = torch.sum(r * z, 0)
            p = z + (rz_new / rz) * p
            rz = rz_new
        claimed = float(criterion(b - _spmv(A, x)))
        y = x.double().cpu().numpy()
        self.solver_timing = {"residue": claimed, "iterations": float(it),
                              "solve_upload": 0.0,
                              "cycles": (time.perf_counter() - t0) * 1000}
        return y[:, 0] if squeeze else y


class ReferenceFlow:
    """The cMCF step (``ConformalFlow.step``'s equations) with every stage
    held in ``np_dtype`` and its solve in ``ReferenceSolver(dtype)``, whose
    criterion keeps the start's mass, as the flow's solver does."""

    def __init__(self, V, F, tau, dtype, np_dtype, device, tolerance=1e-4):
        self.F = np.asarray(F)
        self.tau = float(tau)
        self.np_dtype = np_dtype
        V0 = normalize_area(np.asarray(V, dtype=np.float64), self.F)
        self.V = V0.astype(np_dtype).astype(np.float64)
        self.S = cotan_laplacian(self.V, self.F).astype(np_dtype)
        self.solver = ReferenceSolver(mass_barycentric(self.V, self.F), dtype,
                                      device, tolerance)

    def step(self, *, tol: float = 1e-4) -> np.ndarray:
        dt = self.np_dtype
        M = mass_barycentric(self.V, self.F).astype(dt)
        lhs = (M + dt(self.tau) * self.S).tocsr()
        rhs = (M @ self.V.astype(dt)).astype(dt)
        self.solver.tolerance = float(tol)
        x = np.asarray(self.solver.solve(lhs, rhs)).astype(dt)
        V = x - x.mean(axis=0, keepdims=True, dtype=dt)
        V = normalize_area(V.astype(np.float64), self.F).astype(dt)
        self.V = V.astype(np.float64)
        return self.V
