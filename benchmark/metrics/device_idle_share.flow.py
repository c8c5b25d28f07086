"""Share of the profiled flow steps' window in which no device operation
ran, in percent."""


def read(run):
    if run.kind != "flow" or run.profile is None:
        return None
    return 100.0 * run.profile.idle_share
