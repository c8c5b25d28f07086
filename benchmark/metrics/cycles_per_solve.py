"""Mean of ``solver_timing["iterations"]`` over solves."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "iterations")
