"""A configuration's inputs, made by the module its ``mesh.kind`` names.

``make(mesh_cfg)`` imports ``inputs/<kind>.py`` beside this file and calls
its ``make(mesh_cfg)``, which gives an :class:`Inputs`.  Each kind is plain
NumPy/SciPy and imports nothing of the program, so the inputs, and the
reference that recomputes from them, stay as they are whatever the program's
own generators do.  Adding a kind is adding a file.
"""

from __future__ import annotations

import functools
import importlib


class Inputs:
    """Positions ``V``, faces ``F`` (None for a point cloud), stiffness
    ``S``, mass ``M`` and a length scale ``h``.  ``S``, ``M`` and ``h`` are
    worked out on first use, so a cell that needs only ``V`` and ``F`` (a
    flow builds its own operators) pays for nothing else."""

    def __init__(self, V, F, operators, length):
        self.V, self.F = V, F
        self._operators = operators     # () -> (S, M)
        self._length = length           # (Inputs) -> h

    @functools.cached_property
    def _SM(self):
        return self._operators()

    @property
    def S(self):
        return self._SM[0]

    @property
    def M(self):
        return self._SM[1]

    @functools.cached_property
    def h(self) -> float:
        return float(self._length(self))


def make(mesh: dict) -> Inputs:
    """The inputs of a configuration's ``mesh`` entry."""
    kind = mesh["kind"]
    if not kind.isidentifier():
        raise ValueError(f"unknown mesh kind {kind!r}")
    try:
        module = importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{kind}":
            raise
        raise ValueError(f"unknown mesh kind {kind!r}: no "
                         f"benchmark/reference/inputs/{kind}.py") from None
    return module.make(mesh)
