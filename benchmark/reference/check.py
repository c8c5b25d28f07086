"""The comparison that decides ``correct``.

Every number is worked out in f64 from the benchmark's own inputs with
plain NumPy/SciPy; the program's answers are only read to be judged.

- ``residual``: the criterion-2 residual ``sqrt(r' M r / b' M b)``,
  ``r = A x - b``, of each judged answer, the largest over its columns and
  over the answers.  Its limit is the configuration's tolerance.
- ``residue_gap``: ``|claimed - residual| / residual``, where ``claimed``
  is the residual the solve reported for the same answer
  (``solver_timing["residue"]``).  A solve that computes in the precision
  its configuration states reports its own residual to many digits.
- ``position_gap`` (flow steps): the largest distance between the
  positions a step returned and the reference's recentring and area
  normalization of the answer that step's solve gave, over the largest
  coordinate.

An answer that never came reads ``inf`` on every number.
"""

from __future__ import annotations

import math

import numpy as np

from .mesh import cotan_laplacian, mass_barycentric, normalize_area


def residual_columns(lhs, M, rhs, x) -> np.ndarray:
    """Criterion-2 residual of each column of ``x`` (f64)."""
    rhs2 = np.asarray(rhs, dtype=np.float64).reshape(lhs.shape[0], -1)
    x2 = np.asarray(x, dtype=np.float64).reshape(lhs.shape[0], -1)
    r = lhs @ x2 - rhs2
    num = (r * (M @ r)).sum(axis=0)
    den = np.maximum((rhs2 * (M @ rhs2)).sum(axis=0), 1e-300)
    return np.sqrt(num / den)


def _gap(claimed, true) -> float:
    if claimed is None or not math.isfinite(claimed):
        return math.inf
    return abs(claimed - true) / max(true, 1e-300)


class Judge:
    """Keeps the worst reading of each number over the judged answers."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.worst = {name: 0.0 for name in self.limits}
        self.failed = 0

    def add(self, **numbers) -> None:
        bad = False
        for name, value in numbers.items():
            if name not in self.limits:
                continue
            value = float(value)
            if math.isnan(value):
                value = math.inf
            self.worst[name] = max(self.worst[name], value)
            bad |= not value <= self.limits[name]
        self.failed += bad

    def missing(self) -> None:
        self.add(**{name: math.inf for name in self.limits})

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            self.worst[n] <= self.limits[n] for n in self.limits)

    def numbers(self) -> dict:
        return {n: {"value": self.worst[n], "limit": self.limits[n]}
                for n in self.limits}


def judge_solves(samples, lhs, M, limits: dict) -> Judge:
    """``samples``: ``(rhs, x, claimed)`` of the judged calls; ``x`` None
    where a call gave no answer."""
    judge = Judge(limits)
    for rhs, x, claimed in samples:
        if x is None:
            judge.missing()
            continue
        res = float(np.max(residual_columns(lhs, M, rhs, x)))
        judge.add(residual=res, residue_gap=_gap(claimed, res))
    return judge


class FlowReference:
    """The flow's systems, recomputed from the positions the program
    returned: ``M_t = mass(V_t)``, ``(M_t + tau S_0) x = M_t V_t``, then the
    recentring and area normalization of ``x``.  ``S_0`` is the cotan
    stiffness of the area-normalized input, as in cMCF.  The criterion's
    norm is the start's mass ``M_0``: the flow's solver keeps the mass it
    was built with, as the reference demo's does."""

    def __init__(self, V_in, F, tau: float):
        self.F = np.asarray(F)
        self.V0 = normalize_area(np.asarray(V_in, dtype=np.float64), self.F)
        self.S0 = cotan_laplacian(self.V0, self.F)
        self.M0 = mass_barycentric(self.V0, self.F)
        self.tau = float(tau)

    def system(self, V):
        M = mass_barycentric(V, self.F)
        return (M + self.tau * self.S0).tocsr(), M, M @ V

    def positions(self, x):
        V = np.asarray(x, dtype=np.float64)
        V = V - V.mean(axis=0, keepdims=True)
        return normalize_area(V, self.F)


def judge_flow(samples, ref: FlowReference, limits: dict) -> Judge:
    """``samples``: ``(V_t, x, claimed, V_next)`` of the judged steps, with
    ``V_t`` None at the start of a session (the reference's own start),
    else the positions the previous step returned."""
    judge = Judge(limits)
    for V_t, x, claimed, V_next in samples:
        if x is None or V_next is None:
            judge.missing()
            continue
        lhs, M, rhs = ref.system(ref.V0 if V_t is None else V_t)
        res = float(np.max(residual_columns(lhs, ref.M0, rhs, x)))
        want = ref.positions(x)
        pos = float(np.max(np.abs(np.asarray(V_next) - want))
                    / max(np.max(np.abs(want)), 1e-300))
        judge.add(residual=res, residue_gap=_gap(claimed, res),
                  position_gap=pos)
    return judge
