"""Mean over solves of the facade's pattern-key span,
``solver_timing["facade_pattern_key"]``: the context lookup, an exact byte
compare of the LHS pattern (``indptr``, ``indices``) against the facade's
own copy of each stored context's pattern."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "facade_pattern_key")
