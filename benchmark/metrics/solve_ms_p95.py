"""95th percentile of every facade solve's host-clock time in the window,
from the call to the returned x."""

from benchmark.record import p95


def read(run):
    if run.kind != "solve":
        return None
    return p95(c.wall_ms for c in run.calls)
