"""Mean over flow steps of the step's wall time less the value refresh,
the upload and the loop: the mass rebuild, the assembly, the facade's hash
and compare, the copy back and the normalization."""

from benchmark.record import mean

KEYS = ("reduction", "plan_build", "solve_upload", "cycles")


def read(run):
    if run.kind != "flow":
        return None
    return mean(c.wall_ms - sum(c.timing[k] for k in KEYS)
                for c in run.plain if all(k in c.timing for k in KEYS))
