"""Share of its roofline the dense ADMM chunk kernel reaches over the window:
the launches' least time at the published float32 and HBM peaks
(``port_bench/roofline.py``, from each launch's solved lanes, shapes
and iterations) over the device time of the kernels named
``admm_dense_*``, in %."""


def read(run):
    bound = run.chunk_bound_s.get("dense")
    if run.trace is None or not bound:
        return None
    n, ns = run.trace.kernel_ns("admm_dense_")
    return 100.0 * bound / (ns / 1e9) if n and ns else None
