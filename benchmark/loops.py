"""The general traffic generator: each traffic kind's set-up, its closed loop
of calls, and the answers it keeps for the check.

A traffic file (``traffic/<name>.json``) names its ``kind`` and gives its
parameters; the kinds are ``solve`` (``MultigridSolver.solve`` on one
system, a new right-hand side each call) and ``flow``
(``ConformalFlow.step`` in sessions that restart from the same positions).
One caller waits for each call before it makes the next.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from .record import Call
from .reference import inputs
from .reference.check import FlowReference, judge_flow, judge_solves
from .reference.mesh import system_matrix

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
    """The system under test: the port's facade and its flow."""

    def __init__(self, device):
        self.device = device

    def _dtype(self, cfg):
        import torch

        return getattr(torch, cfg["solver"]["dtype"])

    def solver(self, cfg, inp):
        from gravo_mg_tpu_torch import MultigridSolver

        return MultigridSolver(inp.V, neighbors(cfg, inp), inp.M,
                               dtype=self._dtype(cfg), device=self.device,
                               **solver_kwargs(cfg))

    def flow(self, cfg, V_in, F):
        from gravo_mg_tpu_torch import MultigridSolver
        from gravo_mg_tpu_torch.models.problems import ConformalFlow

        dtype, kw = self._dtype(cfg), solver_kwargs(cfg)

        def factory(V0, neigh, M):
            return MultigridSolver(V0, neigh, M, dtype=dtype,
                                   device=self.device, **kw)

        return ConformalFlow(V_in, F, tau=cfg["tau"], solver_factory=factory)


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


def _rhs_pool(traffic, inp, rng):
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


class SolveCell:
    """``MultigridSolver.solve(lhs, rhs, mode=...)`` on one system."""

    span = "facade.solve"

    def __init__(self, system, cfg, traffic, seed, log):
        rng = np.random.default_rng(seed)
        inp = inputs.make(cfg["mesh"])
        self.M = inp.M
        self.lhs = system_matrix(cfg, inp.S, self.M)
        self.pool = _rhs_pool(traffic, inp, rng)
        log(f"inputs: n={inp.V.shape[0]} nnz={self.lhs.nnz} pool={len(self.pool)}")
        self.order_rng = np.random.default_rng([seed, 2])
        self.idx = 0
        self.mode = traffic["mode"]
        self.solver = system.solver(cfg, inp)
        log("solver built")
        self.first_timing = None
        for i in range(int(traffic["warmup_calls"])):
            self.solver.solve(self.lhs, self.pool[i % len(self.pool)],
                              mode=self.mode)
            if self.first_timing is None:
                self.first_timing = dict(self.solver.solver_timing)
        log("warmed up")

    def call(self, i, profiled):
        # a seeded order in which no call repeats the previous one's vector
        self.idx = (self.idx + int(self.order_rng.integers(1, len(self.pool)))) \
            % len(self.pool)
        rhs = self.pool[self.idx]
        t0 = time.perf_counter()
        x = self.solver.solve(self.lhs, rhs, mode=self.mode)
        wall = (time.perf_counter() - t0) * 1000
        timing = self.solver.solver_timing
        return (Call(wall, timing, dispatched(self.solver), profiled),
                (rhs, x, timing.get("residue")))

    @property
    def facade(self):
        return self.solver

    def referee(self):
        """The check of this cell's answers, from its inputs alone."""
        lhs, M = self.lhs, self.M
        return lambda samples, limits: judge_solves(samples, lhs, M, limits)


class FlowCell:
    """``ConformalFlow.step()`` in sessions of ``session_steps`` steps, each
    session from the same starting positions, on one solver and hierarchy."""

    span = "flow.step"

    def __init__(self, system, cfg, traffic, seed, log):
        rng = np.random.default_rng(seed)
        inp = inputs.make(cfg["mesh"])
        if inp.F is None:
            raise ValueError(
                f"the flow kind needs a mesh with faces; {cfg['mesh']['kind']!r} "
                "has none (the flow's reference is built on faces)")
        V, self.F = inp.V, inp.F
        h = inp.h * float(traffic["start_jitter"])
        self.V_in = V + h * rng.standard_normal(V.shape)
        self.tau, self.tol = cfg["tau"], cfg["solver"]["tolerance"]
        self.session = int(traffic["session_steps"])
        self.flow = system.flow(cfg, self.V_in, self.F)
        self.V0 = self.flow.V
        log(f"inputs: n={V.shape[0]}; flow built")
        solver = self.flow.solver
        inner = solver.solve
        self.answers: list = []

        def recording_solve(*args, **kwargs):
            x = inner(*args, **kwargs)
            self.answers.append((x, solver.solver_timing.get("residue")))
            return x

        solver.solve = recording_solve
        self.first_timing = None
        for _ in range(int(traffic["warmup_steps"])):
            self.flow.step(tol=self.tol)
            if self.first_timing is None:
                self.first_timing = dict(solver.solver_timing)
        self.prev = None
        log("warmed up")

    def call(self, i, profiled):
        if i % self.session == 0:
            self.flow.V, self.prev = self.V0, None
        self.answers.clear()
        t0 = time.perf_counter()
        out = self.flow.step(tol=self.tol)
        wall = (time.perf_counter() - t0) * 1000
        x, claimed = self.answers[-1] if self.answers else (None, None)
        answer = (self.prev, x, claimed, out)
        self.prev = out
        solver = self.flow.solver
        return Call(wall, solver.solver_timing, dispatched(solver), profiled), answer

    @property
    def facade(self):
        return self.flow.solver

    def referee(self):
        """The check of this cell's answers, from its inputs alone."""
        ref = FlowReference(self.V_in, self.F, self.tau)
        return lambda samples, limits: judge_flow(samples, ref, limits)


KINDS = {"solve": SolveCell, "flow": FlowCell}
