"""Prolongation-weight assembly (native OpenMP sweep).

Counterpart of ``gravo_mg_tpu/hierarchy/prolongation.py`` on its native
path.  Reference semantics (`gravomg/src/multigrid_solver.cpp:287-457`):
each fine vertex projects onto the candidate triangles of its Voronoi
cell, taking barycentric weights from the best containing triangle, else
the best "inside" edge, else inverse-distance weights over the 3 closest
coarse points.  The result is a row of <= 3 weights summing to 1.
"""

from __future__ import annotations

import numpy as np


def prolongation_weights(
    fine_pos: np.ndarray,
    labels: np.ndarray,
    coarse_pos: np.ndarray,
    coarse_neigh: np.ndarray,
    *,
    check_voronoi: bool = True,
    nested: bool = False,
    samples: np.ndarray | None = None,
    weighting: int = 0,
):
    """Compute (cols (N, 3) int32, weights (N, 3) float32, stats) for one
    hierarchy level; stats counts (triangles, edges, fallbacks)."""
    from ..native import prolongation_weights_cpp

    return prolongation_weights_cpp(
        fine_pos, labels, coarse_pos, coarse_neigh,
        check_voronoi, nested, samples if nested else None, int(weighting),
    )
