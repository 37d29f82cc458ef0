"""Device ms a batch of the kernels launched under the span
``collision.fk`` (the collision terms' FK prologue) inside the range
``sqp.convexify``: eager launches by their host range, replayed ones by
their graph's node map (``port_bench/subspans.py``)."""

from port_bench import subspans


def read(run):
    sub = subspans.of(run)
    if sub is None or not run.n_batches:
        return None
    ns = sub.device_ns("collision.fk", within="sqp.convexify")
    return ns / 1e6 / run.n_batches if ns else None
