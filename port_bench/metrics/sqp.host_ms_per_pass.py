"""Host ms of an SQP pass (the span ``sqp.pass``, one a pass of the
solve's loop) less the part its host-sync spans (``<layer>.sync.<site>``)
cover, the mean over the window's passes."""

import bisect

from port_bench import subspans


def read(run):
    if run.trace is None or run.window_ns is None:
        return None
    lo, hi = run.window_ns
    passes = [(a, b) for a, b in run.trace.ranges.get("sqp.pass", [])
              if lo <= a and b <= hi]
    if not passes:
        return None
    syncs = sorted(r for name in subspans.sync_names(run.trace)
                   for r in run.trace.ranges[name])
    begins = [a for a, _ in syncs]
    host = 0
    for a, b in passes:
        i = bisect.bisect_left(begins, a)
        blocked = 0
        while i < len(syncs) and syncs[i][0] <= b:
            blocked += min(syncs[i][1], b) - syncs[i][0]
            i += 1
        host += b - a - blocked
    return host / 1e6 / len(passes)
