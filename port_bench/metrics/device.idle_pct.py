"""Share of the traced window in which no device span ran, in %."""


def read(run):
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    if hi <= lo or not run.trace.spans:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns(lo, hi) / (hi - lo))
