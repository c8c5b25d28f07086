"""MG-preconditioned constrained quadratic solver (min_quad_with_fixed).

Counterpart of ``gravo_mg_tpu/solver/min_quad.py``, after the reference's
SIG21-subsystem solver ``min_quad_with_fixed_mg_precompute/solve``
(gravomg/src/sig21/min_quad_with_fixed_mg.cpp):

* minimize ``0.5 x^T A x - x^T B`` subject to ``x[known] = Y``;
* precompute eliminates the knowns, ``A_uu = A[unknown][:, unknown]``
  (``:175-184``), slices the finest prolongation's rows to the unknown
  fine vertices (``:193-194``), builds the Galerkin chain on the reduced
  system (``:22-26``) with a tiny diagonal regularization (``:31-36``) and
  factors the coarsest level (``:46-48``);
* solve iterates cycles until the residual (criterion 3, absolute l2, by
  default) drops below tolerance (``:109-133``; defaults tol 1e-3, 20
  iterations), with ``RHS = B_u - A_uk @ Y`` (``:184``).

The reduced system is one more (hierarchy, LHS) pair, so precompute is a
:class:`MultigridSolveContext` on the solver's device over the row-sliced
prolongation; its cycles run through the same SpMV kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..sparse import make_prolongation
from .multigrid import MultigridSolveContext, SolverConfig


def _slice_prolongation_rows(U, rows: np.ndarray):
    """Row-slice a fixed-width Prolongation (host layout (W, Nf))."""
    return make_prolongation(U.host_cols.T[rows], U.host_weights.T[rows],
                             U.ncoarse, dtype=U.weights.dtype)


class MinQuadWithFixedMG:
    """Solve ``min 0.5 x^T A x - x^T B`` with ``x[known] = Y`` via MG.

    ``solver`` is a built :class:`gravo_mg_tpu_torch.MultigridSolver`
    whose hierarchy covers the full vertex set; ``lhs`` is the full SPD
    system matrix.  The constructor performs the reference's precompute
    on ``solver.device``; :meth:`solve` performs the iteration.
    """

    def __init__(
        self,
        solver,
        lhs,
        known,
        *,
        tol: float = 1e-3,
        max_iter: int = 20,
        reg: float = 1e-12,
        criteria: int = 3,
    ):
        lhs = lhs.tocsr()
        n = lhs.shape[0]
        # Y is aligned to the caller's ordering of ``known`` (igl::slice).
        known = np.asarray(known, dtype=np.int64).ravel()
        if known.size and (known.min() < 0 or known.max() >= n):
            raise ValueError("known indices out of range")
        if np.unique(known).size != known.size:
            raise ValueError("known indices must be unique")
        unknown = np.setdiff1d(np.arange(n, dtype=np.int64), known)
        if unknown.size == 0:
            raise ValueError("all degrees of freedom are fixed")
        self.n = n
        self.known = known
        self.unknown = unknown
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.criteria = int(criteria)

        # Reduced operators (min_quad_with_fixed_mg.cpp:175-184).
        self.A_uu = lhs[unknown][:, unknown].tocsr()
        self.A_uk = lhs[unknown][:, known].tocsr()
        # Diagonal regularization after the reference's 1e-12 shift
        # (:31-36), relative to the matrix scale.
        if reg:
            scale = float(np.abs(self.A_uu.diagonal()).mean())
            A_reduced = (self.A_uu + (reg * scale) *
                         sp.identity(unknown.size, format="csr")).tocsr()
        else:
            A_reduced = self.A_uu

        # Slice only the finest prolongation's rows (reference :193-194);
        # deeper levels act on coarse spaces and are reused as they are.
        hierarchy = solver.hierarchy
        levels = list(hierarchy.levels)
        if levels:
            levels[0] = dataclasses.replace(
                levels[0], U=_slice_prolongation_rows(levels[0].U, unknown)
            )
        self._reduced_hierarchy = dataclasses.replace(
            hierarchy,
            dof=[unknown.size] + list(hierarchy.dof[1:]),
            levels=levels,
        )

        mass_uu = solver.mass[unknown][:, unknown].tocsr()
        cfg = SolverConfig(
            cycle_type=solver.cycle_type,
            pre_iters=solver.pre_iters,
            post_iters=solver.post_iters,
            smoother=int(solver.smoother),
        )
        self.ctx = MultigridSolveContext(
            self._reduced_hierarchy, A_reduced, mass_uu, cfg,
            dtype=solver.dtype, device=solver.device,
            diag_min_groups=solver.diag_min_groups,
        )

    def solve(
        self,
        B,
        Y,
        x0: Optional[np.ndarray] = None,
        *,
        tol: Optional[float] = None,
        max_iter: Optional[int] = None,
        mode: str = "traced",
    ):
        """Return ``(x, iters, residual, convergence)``, x full-length
        with the knowns overwritten by Y.

        ``B`` is the full linear term (n,) or (n, d); ``Y`` the fixed
        values (len(known),) or (len(known), d).  Mirrors
        ``min_quad_with_fixed_mg_solve`` (:81-143): reduced RHS
        ``B_u - A_uk Y``, cycles to tolerance.  ``mode`` is the reduced
        context's (``MultigridSolveContext.solve``): ``"traced"`` steps
        the cycles from the host, ``"fused"`` runs the captured cycle on
        the card under a conditional WHILE node, one launch per solve.
        """
        tol = self.tol if tol is None else float(tol)
        max_iter = self.max_iter if max_iter is None else int(max_iter)
        B = np.asarray(B, dtype=np.float64)
        squeeze = B.ndim == 1
        B2 = B[:, None] if squeeze else B
        Y = np.asarray(Y, dtype=np.float64)
        if self.known.size:
            Y2 = Y[:, None] if squeeze and Y.ndim == 1 else np.atleast_2d(Y)
            if Y2.shape[0] != self.known.size:
                Y2 = Y2.reshape(self.known.size, -1)
            rhs = B2[self.unknown] - self.A_uk @ Y2
        else:
            rhs = B2[self.unknown]

        if x0 is not None:
            x0 = np.asarray(x0, dtype=np.float64)
            x0 = (x0[:, None] if x0.ndim == 1 else x0)[self.unknown]
        xu, iters, res, conv = self.ctx.solve(
            rhs, x0, tol=tol, criteria=self.criteria,
            max_iter=max_iter, mode=mode,
        )
        xu2 = xu[:, None] if xu.ndim == 1 else xu
        x = np.empty((self.n, B2.shape[1]), dtype=np.float64)
        x[self.unknown] = xu2
        if self.known.size:
            x[self.known] = Y2
        return (x[:, 0] if squeeze else x), iters, res, conv
