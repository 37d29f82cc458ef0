"""Share of the traced window that is idle device time beginning while a
host-sync span (``<layer>.sync.<site>``) is the innermost open host range
(``Trace.idle_gaps``), in %."""

from port_bench import subspans


def read(run):
    if run.trace is None or run.window_ns is None:
        return None
    if not subspans.sync_names(run.trace):
        return None
    lo, hi = run.window_ns
    if hi <= lo or not run.trace.spans:
        return None
    gaps = run.trace.idle_gaps(lo, hi, len(run.trace.ranges) + 1)
    idle_s = sum(s for name, s in gaps if ".sync." in name)
    return 100.0 * idle_s * 1e9 / (hi - lo)
