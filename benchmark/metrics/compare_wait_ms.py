"""Mean over the solves that ran ahead of their compares of the caller's
wait for them after its solve returned,
``solver_timing["facade_compare_wait"]``."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "facade_compare_wait")
