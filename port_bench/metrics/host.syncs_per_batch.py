"""Blocking device-to-host reads of the port (its counter ``host.syncs``:
every ``profiling.host_read``, one span ``<layer>.sync.<site>`` each) over
the window, per batch."""

from port_bench import subspans


def read(run):
    c = subspans.counters()
    if not c or "host.syncs" not in c or not run.n_batches:
        return None
    return c["host.syncs"] / run.n_batches
