"""CUDA-graph captures made inside the window (aot_cache.STATS.captures,
reset at its start)."""


def read(run):
    return run.captures
