"""Mean over flow steps of the facade's spans inside the step's solve:
the pattern key, the value compare and the copy back."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "flow":
        return None
    return timing_mean(run.plain, "facade_pattern_key", "facade_value_compare",
                       "solve_copy_back")
