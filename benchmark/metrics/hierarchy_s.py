"""The hierarchy build's own span, ``hierarchy_timing["hierarchy"]``, in s."""


def read(run):
    ms = run.hierarchy_timing.get("hierarchy")
    return None if ms is None else ms / 1000.0
