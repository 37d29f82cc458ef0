"""Device ms a batch of the spans launched inside the profiler range
``sqp.convexify`` (replayed graphs through their cudaGraphLaunch calls)."""


def read(run):
    if run.trace is None or not run.n_batches:
        return None
    ns = run.trace.range_device_ns("sqp.convexify")
    return None if ns is None else ns / 1e6 / run.n_batches
