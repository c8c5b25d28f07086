"""The window's milliseconds over the flow steps completed in it."""


def read(run):
    if run.kind != "flow" or not run.calls:
        return None
    return run.window_s * 1000.0 / len(run.calls)
