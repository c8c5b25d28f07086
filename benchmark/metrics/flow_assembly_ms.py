"""Mean over flow steps of the step's assembly span,
``solver_timing["flow_assembly"]``: ``M + tau S`` and ``M @ V``."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "flow":
        return None
    return timing_mean(run.plain, "flow_assembly")
