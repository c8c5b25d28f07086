"""The control (the reference in the program's place, one precision below
the configuration's) comes out not correct, at a size a test run holds.
On the card: ``python3 benchmark/control.py --workload <cell> --seeds ...``
at the cell's own size."""

import pytest

from benchmark.control import run_control
from benchmark.tests.tiny import tiny_root


@pytest.mark.parametrize("cell", ["poisson1m.fused", "poisson1m.fused3",
                                  "smooth262k.rhs3", "smooth262k.flow"])
def test_the_control_is_not_correct(tmp_path, cell):
    root, bench = tiny_root(tmp_path)
    for line in run_control(cell, [11, 2**31 + 12], 0.2, "cpu", root=root,
                            bench_dir=bench):
        assert line["correct"] is False, line
