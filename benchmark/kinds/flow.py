"""Traffic kind ``flow``: ``ConformalFlow.step()`` in sessions that restart
from the same seeded jittered positions.  One call is one step, so its
calls feed the ``flow`` family of metrics."""

import time

import numpy as np

from benchmark.loops import Operators, dispatched, solver_kwargs
from benchmark.record import Call
from benchmark.reference import inputs
from benchmark.reference.check import FlowReference, judge_flow

FAMILY = "flow"


def program(side, cfg, V_in, F):
    """The port's ``ConformalFlow`` on a facade built from the
    configuration's solver settings."""
    import torch

    from gravo_mg_tpu_torch import MultigridSolver
    from gravo_mg_tpu_torch.models.problems import ConformalFlow

    dtype, kw = getattr(torch, cfg["solver"]["dtype"]), solver_kwargs(cfg)

    def factory(V0, neigh, M):
        return MultigridSolver(V0, neigh, M, dtype=dtype, device=side.device,
                               **kw)

    return ConformalFlow(V_in, F, tau=cfg["tau"], solver_factory=factory)


def control(side, cfg, V_in, F):
    """The plain cMCF step, every stage held in the control's dtype."""
    from benchmark.reference.solver import ReferenceFlow

    if side.np_dtype is None:
        raise ValueError(f"no host dtype for {side.dtype}")
    return ReferenceFlow(V_in, F, cfg["tau"], side.dtype, side.np_dtype,
                         side.device, cfg["solver"]["tolerance"])


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
        self.flow = system.build(program, control, cfg, self.V_in, self.F)
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

    def operators(self):
        """The hierarchy's prolongations only, for counting a traced step's
        applies: a step's system changes with every step, so no roofline."""
        U = getattr(self.facade, "prolongation_matrices", None)
        return Operators(None, U, None, self.V0.shape[1])

    def referee(self):
        """The check of this cell's answers, from its inputs alone."""
        ref = FlowReference(self.V_in, self.F, self.tau)
        return lambda samples, limits: judge_flow(samples, ref, limits)


Cell = FlowCell
