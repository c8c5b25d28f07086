"""Mean over solves of ``solver_timing["loop_device"]``: the loop's time on
the device, between two CUDA events around it (every pass of the fused
loop's WHILE body, which the profiler's trace does not see)."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    return timing_mean(run.plain, "loop_device")
