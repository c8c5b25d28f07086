"""Carry state from the JAX package into the port's objects.

The functions take the reference's objects duck-typed, reading only plain
attributes through ``np.asarray``, so this module never imports
``gravo_mg_tpu`` or JAX.  Tests use it to feed both packages identical
hierarchies and level operators.
"""

from __future__ import annotations

import numpy as np
import torch

from .hierarchy.builder import Hierarchy, HierarchyLevel
from .solver.multigrid import LevelOps
from .sparse import (
    DiagEll,
    EllMatrix,
    Prolongation,
    ShuffleEll,
    ShuffleTransfer,
    make_prolongation,
)


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))   # a writable host copy
    return t if dtype is None else t.to(dtype)


def hierarchy_from_reference(ref) -> Hierarchy:
    """A port Hierarchy from a reference hierarchy (``dof``, ``levels`` with
    ``U.host_cols``/``U.host_weights`` in the (W, Nf) layout, samples,
    labels, coarse points/neighbors, stats)."""
    levels = []
    for lvl in ref.levels:
        U = make_prolongation(
            np.asarray(lvl.U.host_cols).T, np.asarray(lvl.U.host_weights).T,
            int(lvl.U.ncoarse),
        )
        levels.append(HierarchyLevel(
            U=U,
            samples=np.asarray(lvl.samples),
            labels=np.asarray(lvl.labels),
            coarse_points=np.asarray(lvl.coarse_points),
            coarse_neigh=np.asarray(lvl.coarse_neigh),
            stats=np.asarray(lvl.stats),
            coarse_nrm=getattr(lvl, "coarse_nrm", None),
            cluster_dist=getattr(lvl, "cluster_dist", None),
        ))
    return Hierarchy(
        [int(d) for d in ref.dof], levels, np.asarray(ref.points),
        np.asarray(ref.neigh), dict(ref.timing),
    )


def operator_from_reference(A):
    """A port DiagEll / ShuffleEll / EllMatrix from a reference operator,
    told apart by its fields (start / q / indices)."""
    if hasattr(A, "start"):
        return DiagEll(_t(A.start, torch.int32), _t(A.r, torch.int8), _t(A.v),
                       int(A.tg), int(A.nrows), int(A.ncols))
    if hasattr(A, "q"):
        return ShuffleEll(_t(A.q, torch.int32), _t(A.r, torch.int8), _t(A.v),
                          int(A.nrows), int(A.ncols))
    return EllMatrix(_t(A.indices, torch.int64), _t(A.values), int(A.ncols))


def transfer_from_reference(U):
    """A port ShuffleTransfer (fields U/UT) or Prolongation (fields
    cols/weights) from a reference transfer operator."""
    if hasattr(U, "UT"):
        return ShuffleTransfer(
            operator_from_reference(U.U), operator_from_reference(U.UT)
        )
    cols = np.asarray(U.cols)
    weights = np.asarray(U.weights)
    return Prolongation(_t(cols, torch.int64), _t(weights), int(U.ncoarse),
                        cols.astype(np.int32), weights)


def levels_from_reference(levels, coarse_op, device="cpu"):
    """(levels, coarse) for the port's cycle from a reference context's
    ``levels`` (A, diag_inv, lam_max, U) and ``coarse_op`` (Ainv, Ad)."""
    out = tuple(
        LevelOps(
            operator_from_reference(lvl.A), _t(lvl.diag_inv),
            float(np.asarray(lvl.lam_max)), transfer_from_reference(lvl.U),
        ).to(device)
        for lvl in levels
    )
    coarse = tuple(_t(a).to(device) for a in coarse_op)
    return out, coarse
