"""Share of the solves that ran ahead of their compares,
``solver_timing["facade_ran_ahead"]``, in percent."""

from benchmark.record import timing_mean


def read(run):
    if run.kind != "solve":
        return None
    share = timing_mean(run.plain, "facade_ran_ahead")
    return None if share is None else 100.0 * share
