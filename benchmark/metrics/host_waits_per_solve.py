"""Mean of ``solver_timing["host_reads"]`` over solves (the device loop
sets it)."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "host_reads")
