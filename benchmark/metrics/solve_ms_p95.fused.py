"""95th percentile of the host-clock time of the facade solves outside the
profiled calls, from the call to the returned x: the tail of the device
loop's calls, kept per layer where it spreads too widely run to run for
an end-to-end bound."""

from benchmark.record import p95


def read(run):
    if run.kind != "solve":
        return None
    return p95(c.wall_ms for c in run.plain)
