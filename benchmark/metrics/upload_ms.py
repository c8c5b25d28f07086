"""Mean over solves of the solve's upload span,
``solver_timing["solve_upload"]``: the right-hand side to the device in
f64 as given (a pageable copy), the device's constant-mode deflation and
the criterion's denominator, up to the wait for the device."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "solve_upload")
