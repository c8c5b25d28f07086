"""Traffic kind ``solve``: ``MultigridSolver.solve(lhs, rhs, mode=...)`` on
one system, a new right-hand side from a seeded pool each call, never the
previous call's.  One call answers one right-hand side of ``columns``
columns, so its calls feed the ``solve`` family of metrics."""

import time

import numpy as np

from benchmark.loops import (
    Operators,
    rhs_pool,
    dispatched,
    neighbors,
    solver_kwargs,
)
from benchmark.record import Call
from benchmark.reference import inputs
from benchmark.reference.check import judge_solves
from benchmark.reference.mesh import system_matrix

FAMILY = "solve"


def program(side, cfg, inp):
    """The port's facade on the configuration's system."""
    import torch

    from gravo_mg_tpu_torch import MultigridSolver

    return MultigridSolver(inp.V, neighbors(cfg, inp), inp.M,
                           dtype=getattr(torch, cfg["solver"]["dtype"]),
                           device=side.device, **solver_kwargs(cfg))


def control(side, cfg, inp):
    """The plain Jacobi-PCG reference in the control's dtype."""
    from benchmark.reference.solver import ReferenceSolver

    return ReferenceSolver(inp.M, side.dtype, side.device,
                           tolerance=cfg["solver"]["tolerance"])


class SolveCell:
    """``MultigridSolver.solve(lhs, rhs, mode=...)`` on one system."""

    span = "facade.solve"

    def __init__(self, system, cfg, traffic, seed, log):
        rng = np.random.default_rng(seed)
        inp = inputs.make(cfg["mesh"])
        self.M = inp.M
        self.lhs = system_matrix(cfg, inp.S, self.M)
        self.pool = rhs_pool(traffic, inp, rng)
        self.columns = int(traffic["columns"])
        log(f"inputs: n={inp.V.shape[0]} nnz={self.lhs.nnz} pool={len(self.pool)}")
        self.order_rng = np.random.default_rng([seed, 2])
        self.idx = 0
        self.mode = traffic["mode"]
        self.solver = system.build(program, control, cfg, inp)
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

    def operators(self):
        """The system, the hierarchy's prolongations and the criterion's
        mass, whose applies the traced run's roofline counts."""
        U = getattr(self.solver, "prolongation_matrices", None)
        return Operators(self.lhs, U, self.M, self.columns)

    def referee(self):
        """The check of this cell's answers, from its inputs alone."""
        lhs, M = self.lhs, self.M
        return lambda samples, limits: judge_solves(samples, lhs, M, limits)


Cell = SolveCell
