"""Profiling hooks: ``torch.profiler`` traces + solve-counter reporting.

Counterpart of ``trajopt_tpu/utils/profiling.py``.  The reference's
tracing story is the per-iteration merit table, CSV logs and Google
Benchmark; here ``with trace(log_dir): solve(...)`` writes a Chrome trace
(``chrome://tracing``, Perfetto) of the host ops and, on a CUDA machine,
the device kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from trajopt_tpu_torch.utils import to_numpy


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with CPU and (where a CUDA device is present) CUDA
    activities and write the Chrome trace ``trace_<pid>_<ns>.json`` into
    ``log_dir``; yields the profiler."""
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=act) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))



def solve_counters(result) -> dict:
    """The OptResults counters (n_func_evals, n_qp_solves,
    optimizers.hpp:47) aggregated over a batch."""
    return {
        "n_func_evals": int(to_numpy(result.n_func_evals).sum()),
        "n_qp_solves": int(to_numpy(result.n_qp_solves).sum()),
        "mean_sqp_iter": float(to_numpy(result.n_iter).mean()),
    }


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class Timer:
    """Wall-clock scope timer that waits for the device work of the
    observed result (the clock utility of trajopt_common): on exit every
    CUDA device holding one of its tensors is synchronized before the
    clock stops."""

    def __init__(self):
        self.elapsed = None
        self._result = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def observe(self, tree):
        self._result = tree
        return tree

    def __exit__(self, *exc):
        if self._result is not None:
            for dev in {t.device for t in _tensors(self._result)
                        if t.is_cuda}:
                torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        return False


def machine_cache_dir(name: str) -> str:
    """A per-CPU-model persistent cache path (a copy of the JAX package's).

    Artifacts compiled for one host's CPU features may crash on another;
    keying the directory by a fingerprint of the CPU flags makes stale
    entries unreachable instead of fatal.
    """
    import hashlib
    import platform
    import tempfile

    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    fp = hashlib.sha1(
        (platform.machine() + flags).encode()).hexdigest()[:12]
    # Include the UID: a world-shared tempdir path keyed only by CPU flags
    # could be owned by another user, making cache writes fail.
    try:
        uid = os.getuid()
    except AttributeError:  # non-POSIX
        uid = 0
    return f"{tempfile.gettempdir()}/{name}_u{uid}_{fp}"
