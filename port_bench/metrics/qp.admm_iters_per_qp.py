"""ADMM iterations a lane's QP solve runs, the mean over the window: the
port's counters ``qp.admm.lane_iters`` (live lanes times ``check_every``
at each chunk) over ``qp.admm.lane_solves`` (lanes entering a solve)."""

from port_bench import subspans


def read(run):
    c = subspans.counters()
    if not c or not c.get("qp.admm.lane_solves"):
        return None
    return c["qp.admm.lane_iters"] / c["qp.admm.lane_solves"]
