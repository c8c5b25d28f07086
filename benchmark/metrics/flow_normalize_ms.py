"""Mean over flow steps of the step's normalization span,
``solver_timing["flow_normalize"]``: the mean removal and the area
normalization."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "flow":
        return None
    return timing_mean(run.plain, "flow_normalize")
