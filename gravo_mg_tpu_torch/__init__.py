"""gravo_mg_tpu_torch — the PyTorch/CUDA port of gravo_mg_tpu.

Geometric multigrid for sparse SPD systems on triangle meshes and point
clouds (Gravo MG capabilities), with the JAX package's API::

    from gravo_mg_tpu_torch import MultigridSolver
    solver = MultigridSolver(pos, neigh, mass)          # device="cuda"
    x = solver.solve(lhs, rhs)

The host half (hierarchy, native C++ setup kernels, slot layouts, Galerkin
chain) is numpy/scipy/ctypes; the device half is PyTorch with hand-written
CUDA SpMV kernels for Hopper (``csrc/``).  The package imports no JAX and
nothing of ``gravo_mg_tpu``.
"""

from .core import MultigridSolver
from .enums import CycleType, Hierarchy, Sampling, Smoother, Weighting
from .hierarchy.builder import build_hierarchy
from .solver.min_quad import MinQuadWithFixedMG
from .sparse import (
    DiagEll, EllMatrix, Prolongation, ShuffleEll, SlicedDiag, SlicedEll,
    ell_from_scipy, spmv,
)

__all__ = [
    "MultigridSolver",
    "Hierarchy",
    "Sampling",
    "Weighting",
    "CycleType",
    "Smoother",
    "DiagEll",
    "EllMatrix",
    "Prolongation",
    "ShuffleEll",
    "SlicedDiag",
    "SlicedEll",
    "ell_from_scipy",
    "spmv",
    "build_hierarchy",
    "MinQuadWithFixedMG",
]
