"""Newton-Schulz iterations a lane's refresh of the carried KKT inverse
runs, the mean over the window: the port's counters ``qp.ns.lane_iters``
(the lanes' iterations, read once a refresh) over
``qp.ns.lane_refreshes`` (lanes refreshed).  None where the port keeps no
such counters."""

from port_bench import subspans


def read(run):
    c = subspans.counters()
    if not c or not c.get("qp.ns.lane_refreshes"):
        return None
    return c["qp.ns.lane_iters"] / c["qp.ns.lane_refreshes"]
