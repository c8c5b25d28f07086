"""Mean over flow steps of the step's mass-rebuild span,
``solver_timing["flow_mass"]``."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "flow":
        return None
    return timing_mean(run.plain, "flow_mass")
