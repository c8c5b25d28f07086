"""Mean over solves of the call's wall time less the context's upload and
loop spans: the facade's own host work (pattern hash, value compare,
context lookup) and the copy back."""

from benchmark.record import mean


def read(run):
    if run.kind != "solve":
        return None
    return mean(c.wall_ms - c.timing["solve_upload"] - c.timing["cycles"]
                for c in run.plain
                if "solve_upload" in c.timing and "cycles" in c.timing)
