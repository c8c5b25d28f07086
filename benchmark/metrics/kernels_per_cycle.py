"""Device kernels in the profiled solves over the cycles they dispatched."""


def read(run):
    cycles = sum(c.dispatched for c in run.traced)
    if run.kind != "solve" or run.profile is None or cycles <= 0:
        return None
    return run.profile.kernels / cycles
