"""Format-neutral bytes of the profiled solves' sparse applies over the
card's peak bandwidth times the device time of the kernels named *spmv*,
in percent."""


def read(run):
    p = run.profile
    if (run.kind != "solve" or p is None or p.spmv_s <= 0
            or run.bytes_per_cycle <= 0 or not run.traced):
        return None
    nbytes = sum(c.dispatched * run.bytes_per_cycle + run.bytes_per_solve
                 for c in run.traced)
    return 100.0 * nbytes / (run.hbm_bytes_per_s * p.spmv_s)
