"""Device ms a batch of the primitive narrowphase kernels (every
instantiation's name holds ``primitive_narrowphase_kernel``)."""


def read(run):
    if run.trace is None or not run.n_batches:
        return None
    n, ns = run.trace.kernel_ns("primitive_narrowphase_kernel")
    return ns / 1e6 / run.n_batches if n else None
