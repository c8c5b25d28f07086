"""Public enums, mirroring the reference's pybind11 exports
(`gravomg_bindings/src/cpp/core.cpp:165-179`)."""

from __future__ import annotations

import enum


class Hierarchy(enum.IntEnum):
    OURS = 0
    SIG21 = 1
    SIG21BARY = 2


class Sampling(enum.IntEnum):
    FASTDISK = 0
    POISSONDISK = 1
    FPS = 2
    RANDOM = 3
    MIS = 4


class Weighting(enum.IntEnum):
    BARYCENTRIC = 0
    UNIFORM = 1
    INVDIST = 2


class CycleType(enum.IntEnum):
    V = 0
    F = 1
    W = 2


class Smoother(enum.IntEnum):
    """Parallel smoother families.

    The reference's serial Gauss-Seidel (`multigrid_solver.cpp:1194-1226`)
    is inherently sequential; on the device the same role (cheap high-frequency
    damping) is filled by damped Jacobi and Chebyshev-accelerated Jacobi.
    """

    JACOBI = 0
    CHEBYSHEV = 1
