"""Facade solves completed in the window over the window's seconds."""

from benchmark.record import rate


def read(run):
    if run.kind != "solve":
        return None
    return rate(len(run.calls), run.window_s)
