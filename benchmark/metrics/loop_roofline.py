"""The fused loop's share of the card's bandwidth roofline, in percent:
the format-neutral bytes of the cycles the solves ran (``iterations`` times
``roofline.cycle_bytes``' bytes per cycle, in the configuration's itemsize)
over the peak bandwidth times the loop's device time between its two CUDA
events (``loop_device``, every pass of the WHILE body), over the calls
outside the profiled ones.  None where the program times no device loop."""


def read(run):
    if run.kind != "solve" or run.bytes_per_cycle <= 0:
        return None
    calls = [c for c in run.plain
             if "loop_device" in c.timing and "iterations" in c.timing]
    seconds = sum(c.timing["loop_device"] for c in calls) / 1000.0
    if not calls or seconds <= 0:
        return None
    nbytes = sum(c.timing["iterations"] for c in calls) * run.bytes_per_cycle
    return 100.0 * nbytes / (run.hbm_bytes_per_s * seconds)
