"""Queries of the primitive narrowphase kernel's groups over the window
(the port's counter ``collision.primitive.queries``: pad lanes included,
replays of captured regions included), per batch."""

from port_bench import subspans


def read(run):
    c = subspans.counters()
    if not c or "collision.primitive.queries" not in c or \
            not run.n_batches:
        return None
    return c["collision.primitive.queries"] / run.n_batches
