"""What the traffic kinds share: the side that builds the system under
test, the closed loop of calls, the reservoir of kept answers and the
right-hand-side pool.

A traffic file (``traffic/<name>.json``) names its ``kind`` and gives its
parameters; each kind is a file ``kinds/<kind>.py`` that the harness finds
by that name (``solve``: ``MultigridSolver.solve`` on one system, a new
right-hand side each call; ``flow``: ``ConformalFlow.step`` in sessions
that restart from the same positions).  One caller waits for each call
before it makes the next.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

ITEMSIZE = {"float32": 4, "float64": 8}
# the configuration's ``hierarchy`` options, MultigridSolver's arguments
HIERARCHY = ("ratio", "nested", "check_voronoi", "sampling_strategy",
             "weighting")


def solver_kwargs(cfg: dict) -> dict:
    """The configuration's solver settings and its optional ``hierarchy``
    block as ``MultigridSolver`` arguments (the dtype apart); the block's
    ``sampling_strategy`` and ``weighting`` are the names of the program's
    ``Sampling`` and ``Weighting`` members."""
    s = cfg["solver"]
    kw = dict(lower_bound=s["lower_bound"], tolerance=s["tolerance"],
              stopping_criteria=s["stopping_criteria"],
              max_iter=s["max_iter"], cycle_type=s["cycle_type"],
              pre_iters=s["pre_iters"], post_iters=s["post_iters"])
    h = dict(cfg.get("hierarchy", {}))
    unknown = set(h) - set(HIERARCHY)
    if unknown:
        raise ValueError(f"unknown hierarchy options {sorted(unknown)}; "
                         f"known: {HIERARCHY}")
    if "sampling_strategy" in h or "weighting" in h:
        from gravo_mg_tpu_torch.enums import Sampling, Weighting

        for key, enum in (("sampling_strategy", Sampling),
                          ("weighting", Weighting)):
            if key in h:
                h[key] = enum[h[key]]
    return {**kw, **h}


def neighbors(cfg: dict, inp):
    """The solver's neighbour array, by the configuration's ``neighbors``:
    ``"faces"`` (the default, the 1-ring of F) or ``"stiffness"`` (the
    sparsity of S, as the reference's comparisons take for every input)."""
    from gravo_mg_tpu_torch.utils.neighbors import (
        neighbors_from_faces,
        neighbors_from_stiffness,
    )

    how = cfg.get("neighbors", "faces")
    if how == "stiffness":
        return neighbors_from_stiffness(inp.S)
    if how != "faces":
        raise ValueError(f"unknown neighbors {how!r}: faces or stiffness")
    if inp.F is None:
        raise ValueError('a point cloud has no faces: give "neighbors": '
                         '"stiffness"')
    return neighbors_from_faces(inp.F)


class Program:
    """The system under test.  A kind builds what its cell drives through
    its side: ``build(program, control, *args)`` calls the kind's
    ``program(side, *args)``, the port's object (the control's side,
    ``control.Control``, calls ``control`` instead).  A cell hands both
    builders and the side picks one, so the cell makes the same call on
    either side and never asks which it runs on."""

    def __init__(self, device):
        self.device = device

    def build(self, program, control, *args):
        return program(self, *args)


@dataclasses.dataclass
class Operators:
    """What a cell's sparse applies work on: the system, the hierarchy's
    prolongation matrices from the finest level down, the criterion's mass
    and a call's columns.  The traced run counts a call's applies from the
    prolongations, and its roofline bytes from all of them; a None leaves
    that out."""

    lhs: object
    prolongations: object
    mass: object
    columns: int


def dispatched(solver) -> int:
    """Cycles the device ran for the solver's last solve: its newest
    context's count, which holds the host loop's discarded lookahead."""
    contexts = getattr(solver, "_contexts", None)
    if contexts:
        return int(next(reversed(contexts.values())).dispatched)
    return int(solver.solver_timing.get("iterations", 0))


class Reservoir:
    """A uniform sample of ``k`` of all the answers offered, drawn from its
    own seeded stream (Algorithm R)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = int(k), rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


def rhs_pool(traffic, inp, rng):
    """The traffic's seeded pool of ``pool`` right-hand sides: ``mass_randn``
    (M @ a normal n x ``columns`` block) or ``mass_positions_jitter``
    (M @ (V + ``jitter`` h · normal)); a one-column entry as a flat vector."""
    V, M = inp.V, inp.M
    n, size = V.shape[0], int(traffic["pool"])
    if traffic["rhs"] == "mass_randn":
        cols = int(traffic["columns"])
        B = rng.standard_normal((n, cols * size))
        pool = [M @ B[:, i * cols:(i + 1) * cols] for i in range(size)]
    elif traffic["rhs"] == "mass_positions_jitter":
        h = inp.h * float(traffic["jitter"])
        pool = [M @ (V + h * rng.standard_normal(V.shape)) for _ in range(size)]
    else:
        raise ValueError(f"unknown rhs {traffic['rhs']!r}")
    return [np.ascontiguousarray(b[:, 0]) if b.shape[1] == 1 else b for b in pool]


class Loop:
    """The closed loop of one cell: calls ``call(i, profiled)`` until the
    window has passed, offering each call's answer to the reservoir."""

    def __init__(self, call, reservoir, span: str):
        self.call, self.reservoir, self.span = call, reservoir, span
        self.calls: list = []

    def run(self, count=None, seconds=None, profiled=False):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        end = None if seconds is None else t0 + seconds
        i = 0
        while True:
            span = record_function(self.span) if profiled else contextlib.nullcontext()
            with span:
                rec, answer = self.call(len(self.calls), profiled)
            self.calls.append(rec)
            self.reservoir.offer(answer)
            i += 1
            if (count is not None and i >= count) or (
                    end is not None and time.perf_counter() >= end):
                return t0, time.perf_counter()
