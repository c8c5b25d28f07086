"""Mean over solves of the facade's value-compare span,
``solver_timing["facade_value_compare"]``: the LHS values against the
context's."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "facade_value_compare")
