"""Host sparse direct solve, the facade's comparison column.

Counterpart of ``gravo_mg_tpu/solver/direct.py::direct_solve`` (the
reference's solverType 0/1, multigrid_solver.cpp:1287-1366): SuperLU on
the host.  The device CG solve is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def direct_solve(lhs_csr, rhs: np.ndarray, timing: Optional[dict] = None):
    """Host sparse LU factor + solve (SuperLU)."""
    from scipy.sparse.linalg import splu

    t0 = time.perf_counter()
    lu = splu(lhs_csr.tocsc())
    t_factor = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    x = np.asarray(lu.solve(np.asarray(rhs)))
    t_solve = (time.perf_counter() - t0) * 1000
    if timing is not None:
        timing["direct_factor"] = t_factor
        timing["direct_solve"] = t_solve
        timing["direct_backend"] = "superlu"
    return x
