"""Mean over solves of the facade's pattern-key span,
``solver_timing["facade_pattern_key"]``: the SHA-1 of the LHS pattern and
the context lookup."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "facade_pattern_key")
