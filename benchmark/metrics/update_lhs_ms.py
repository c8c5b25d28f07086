"""Mean over flow steps of the value refresh's spans,
``solver_timing["reduction"] + ["plan_build"]``."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "flow":
        return None
    return timing_mean(run.plain, "reduction", "plan_build")
