"""Mean of ``solver_timing["cycles"]`` over solves: the outer loop, from
its first dispatch to its last host wait."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "cycles")
