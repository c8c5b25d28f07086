"""Mean over solves of the solve's copy-back span,
``solver_timing["solve_copy_back"]``: x to the host in f64, the deflated
constant added back."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "solve_copy_back")
