"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size.  The exchange between chips is a fault no cell here can have
(every cell runs on one card)."""

import numpy as np
import pytest

from benchmark import loops
from benchmark.harness import run_cell
from benchmark.tests.tiny import tiny_root


def _break_solve(solver, fault):
    inner = solver.solve

    def broken(lhs, rhs, *args, **kwargs):
        if fault == "altered":        # the answer altered where it is produced
            return inner(lhs, rhs, *args, **kwargs) * (1 + 1e-2)
        # half of the batch left out, the mean of the rest in its place
        rhs = np.asarray(rhs)
        half = (rhs.shape[1] + 1) // 2
        x = inner(lhs, rhs[:, :half], *args, **kwargs)
        rest = np.repeat(x.mean(axis=1, keepdims=True), rhs.shape[1] - half, 1)
        return np.concatenate([x, rest], axis=1)

    solver.solve = broken


class Broken(loops.Program):
    """The program with ``fault`` planted in whatever a kind builds."""

    def __init__(self, fault):
        super().__init__("cpu")
        self.fault = fault

    def build(self, program, control, *args):
        built = super().build(program, control, *args)
        if not hasattr(built, "step"):
            _break_solve(built, self.fault)
        elif self.fault == "unchanged":  # a step that returns its state unchanged
            built.step = lambda tol=1e-4: built.V
        elif self.fault == "altered_positions":
            step = built.step

            def altered(tol=1e-4):
                built.V = step(tol=tol) * (1 + 1e-6)
                return built.V

            built.step = altered
        else:
            _break_solve(built.solver, self.fault)
        return built


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(tiny, cell, system=None):
    root, bench = tiny
    return run_cell(cell, 2**31 + 5, 0.3, False, device="cpu", system=system,
                    root=root, bench_dir=bench)


@pytest.mark.parametrize("cell", ["poisson1m.fused", "poisson1m.fused3",
                                  "smooth262k.rhs3", "smooth262k.flow"])
def test_the_unbroken_program_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"] and r["failed"] == 0, r["check"]


@pytest.mark.parametrize("cell,fault", [
    ("poisson1m.fused", "altered"),
    ("poisson1m.fused3", "altered"),
    ("poisson1m.fused3", "half"),
    ("smooth262k.rhs3", "altered"),
    ("smooth262k.rhs3", "half"),
    ("smooth262k.flow", "altered"),
    ("smooth262k.flow", "altered_positions"),
    ("smooth262k.flow", "unchanged"),
])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    r = _run(tiny, cell, Broken(fault))
    assert not r["correct"] and r["failed"] > 0, r["check"]
