"""Model problems: the reference's demo/experiment systems as components.

Counterpart of ``gravo_mg_tpu/models/problems.py``.  The reference defines
its workloads inside demos and the experiment harness
(demos/smoothing.py:20-74, demos/conformal_flow.py:18-88,
demos/conformal_flow_pointcloud.py:15-91, experiments/python/
comparisons.py:30-96); here each one is a function from geometry to
(solver inputs, LHS, RHS) plus, for the flows, a stepper that iterates
solves.

Systems:
  smoothing:    (M + tau * S) x = M b           tau = 1e-3
  poisson:      (eta * M + S) x = M b           eta = 1e-6
  bilaplacian:  S Minv S in place of S          (comparisons.py:54)
  conformal / mean-curvature flow: iterated smoothing of the positions
  with per-step mass rebuild and area renormalization (conformal_flow.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp

from ..utils.laplacian import (
    cotan_laplacian,
    mass_barycentric,
    mass_voronoi,
    point_cloud_laplacian,
)
from ..utils.neighbors import neighbors_from_stiffness
from ..utils.normalize import normalize_area, normalize_bounding_box
from ..utils.profiler import span


@dataclasses.dataclass
class ProblemSetup:
    """Everything needed to build a MultigridSolver and call solve()."""

    pos: np.ndarray            # (possibly normalized) vertex positions
    faces: Optional[np.ndarray]
    neigh: np.ndarray          # padded neighbor array (solver input)
    mass: sp.csr_matrix        # M
    stiffness: sp.csr_matrix   # S (or S Minv S for bilaplacian systems)
    lhs: sp.csr_matrix         # assembled system matrix
    make_rhs: Callable[[np.ndarray], np.ndarray]  # b -> RHS (= M b)


def _operators(V, F, pointcloud: bool, bilaplacian: bool, normalize: bool):
    if pointcloud or F is None:
        V = normalize_bounding_box(V) if normalize else V
        S, M = point_cloud_laplacian(V)
        F = None
    else:
        V = normalize_area(V, F) if normalize else V
        S = cotan_laplacian(V, F)
        M = mass_voronoi(V, F)
    if bilaplacian:
        Minv = sp.diags(1.0 / np.maximum(M.diagonal(), 1e-300))
        S = (S @ Minv @ S).tocsr()
    neigh = neighbors_from_stiffness(S)
    return V, F, S.tocsr(), M.tocsr(), neigh


def smoothing_problem(
    V, F=None, *, tau: float = 1e-3, bilaplacian: bool = False,
    pointcloud: bool = False, normalize: bool = True,
) -> ProblemSetup:
    """Implicit smoothing ``(M + tau S) x = M b`` (comparisons.py:78,
    demos/smoothing.py)."""
    V, F, S, M, neigh = _operators(V, F, pointcloud, bilaplacian, normalize)
    lhs = (M + tau * S).tocsr()
    return ProblemSetup(V, F, neigh, M, S, lhs, lambda b: M @ b)


def poisson_problem(
    V, F=None, *, eta: float = 1e-6, bilaplacian: bool = False,
    pointcloud: bool = False, normalize: bool = True,
) -> ProblemSetup:
    """Regularized Poisson ``(eta M + S) x = M b`` (comparisons.py:76)."""
    V, F, S, M, neigh = _operators(V, F, pointcloud, bilaplacian, normalize)
    lhs = (eta * M + S).tocsr()
    return ProblemSetup(V, F, neigh, M, S, lhs, lambda b: M @ b)


class ConformalFlow:
    """Iterated mean-curvature / conformal flow (demos/conformal_flow.py).

    Each step rebuilds the mass matrix from the current positions, solves
    ``(M + tau S) V_new = M V`` with the *initial* stiffness S (the cMCF
    trick that drives the surface conformally to a sphere), then
    renormalizes surface area.  The hierarchy is built once; every step's
    LHS has the same sparsity, so the solver keeps one context and
    refreshes only its values (``update_lhs``), never its layouts.
    The default solver runs on ``device``.
    """

    def __init__(
        self, V, F=None, *, tau: float = 1e-3, pointcloud: bool = False,
        solver_factory=None, lower_bound: int = 1000, device="cuda",
    ):
        from ..core import MultigridSolver

        self.tau = float(tau)
        self.pointcloud = bool(pointcloud)
        V0, self.F, S, M, self.neigh = _operators(
            V, F, pointcloud, bilaplacian=False, normalize=True
        )
        self.S = S                     # fixed initial stiffness (cMCF)
        self.V = V0
        # The reference flow uses the barycentric mass per step
        # (conformal_flow.py: igl.massmatrix BARYCENTRIC).
        if self.F is not None:
            M = mass_barycentric(V0, self.F).tocsr()
        self.M = M
        if solver_factory is None:
            self.solver = MultigridSolver(
                V0, self.neigh, M, lower_bound=lower_bound, device=device
            )
        else:
            self.solver = solver_factory(V0, self.neigh, M)

    def _rebuild_mass(self):
        if self.pointcloud or self.F is None:
            _, M = point_cloud_laplacian(self.V)
        else:
            M = mass_barycentric(self.V, self.F)
        self.M = M.tocsr()

    def step(self, *, tol: float = 1e-4) -> np.ndarray:
        """One flow step; returns the updated positions.  The step's host
        spans (``flow_mass``, ``flow_assembly``, ``flow_normalize``, ms) join
        the solve's in ``solver.solver_timing``."""
        timing: dict = {}
        with span(timing, "flow_mass", host_only=True):
            self._rebuild_mass()
        with span(timing, "flow_assembly", host_only=True):
            lhs = (self.M + self.tau * self.S).tocsr()
            rhs = self.M @ self.V
        old_tol, self.solver.tolerance = self.solver.tolerance, float(tol)
        try:
            x = self.solver.solve(lhs, rhs)
        finally:
            self.solver.tolerance = old_tol
        with span(timing, "flow_normalize", host_only=True):
            V = np.asarray(x)
            # Area (or bounding-box for point clouds) renormalization and
            # recentering, as in conformal_flow.py's per-step normalize.
            V = V - V.mean(axis=0, keepdims=True)
            if self.F is not None:
                V = normalize_area(V, self.F)
            else:
                scale = np.abs(V).max()
                V = V / max(scale, 1e-30)
        self.solver.solver_timing.update(timing)
        self.V = V
        return V

    def run(self, steps: int, *, tol: float = 1e-4) -> np.ndarray:
        for _ in range(steps):
            self.step(tol=tol)
        return self.V
