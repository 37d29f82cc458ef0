"""Profiling hooks: spans, counters, ``torch.profiler`` traces and
solve-counter reporting.

Counterpart of ``trajopt_tpu/utils/profiling.py``.  The reference's
tracing story is the per-iteration merit table, CSV logs and Google
Benchmark; here ``with trace(log_dir): solve(...)`` writes a Chrome trace
(``chrome://tracing``, Perfetto) of the host ops and, on a CUDA machine,
the device kernels.

The port's own instrumentation lives here too:

- :func:`span` names a stretch of the solver (``sqp.*``, ``qp.*``,
  ``collision.*``).  Under an active profiler it is a
  ``torch.profiler.record_function`` range, on the trace's clock; without
  one it costs a flag test.  While ``utils/aot_cache.py`` captures a CUDA
  graph, the spans opened inside the captured function are noted against
  the graph's nodes (:class:`Recording`), so that a trace reader can hand
  each kernel of a later replay to the span that launched it.
- :func:`count` adds to the process's counter registry (:func:`counters`,
  :func:`reset`): kernel launches, queries, ADMM and Newton-Schulz lane
  iterations, host syncs, captures and replays.  A captured pass adds
  nothing itself; each replay of its graph adds what the pass counted
  (:func:`replayed`).
- :func:`host_read` is every blocking device-to-host read of the solve:
  the span ``<layer>.sync.<site>`` around it and the counts ``host.syncs``
  and ``host.syncs.<layer>.<site>``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable

import torch

from trajopt_tpu_torch.utils import to_numpy

_COUNTS: dict = {}
_LOCK = threading.Lock()            # guards _COUNTS and _RESETS
_RESETS = [0]                       # how many times reset() has run
_LOCAL = threading.local()          # .rec: this thread's capture Recording
_NO_SPAN = contextlib.nullcontext()


def _add(items) -> None:
    """Add each (name, n) of ``items`` to the registry, or to the captured
    pass's counts where this thread records a capture: the pass runs
    nothing itself, and each replay of its graph adds them."""
    rec = getattr(_LOCAL, "rec", None)
    counts = _COUNTS if rec is None else rec.delta
    with _LOCK:
        for name, n in items:
            counts[name] = counts.get(name, 0) + n


def count(name: str, n=1) -> None:
    """Add ``n`` to the registry's counter ``name``."""
    _add(((name, n),))


def counters() -> dict:
    """A snapshot of the registry: {counter name: count}."""
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    """Clear every counter of the registry."""
    with _LOCK:
        _COUNTS.clear()
        _RESETS[0] += 1


def resets() -> int:
    """How many times :func:`reset` has run in the process: a snapshot of
    :func:`counters` is a base to subtract only while this is unchanged."""
    return _RESETS[0]


def replayed(delta: dict) -> None:
    """Add a captured pass's counts (:attr:`Recording.delta`) once more: a
    replay of its graph did that work again."""
    _add(delta.items())


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str, rec):
        self.name, self.rec, self.range = name, rec, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.rec is not None:
            self.rec.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.exit()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context naming a stretch of the solver: a profiler range ``name``
    while a profiler is active, noted in the node map of a graph being
    captured (:class:`Recording`); otherwise a shared no-op."""
    rec = getattr(_LOCAL, "rec", None)
    if rec is None and not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name, rec)


def host_read(layer: str, site: str, fn: Callable, *args):
    """``fn(*args)``, a read that makes the host wait for the device (``int``
    or ``bool`` of a device scalar, ``torch.nonzero`` of a device mask),
    inside the span ``<layer>.sync.<site>`` and counted under
    ``host.syncs`` and ``host.syncs.<layer>.<site>``.  On CPU tensors the
    read does not wait, and is counted all the same."""
    count("host.syncs")
    count(f"host.syncs.{layer}.{site}")
    with span(f"{layer}.sync.{site}"):
        return fn(*args)


class Recording:
    """What one captured pass counts (``delta``), and where its spans lie
    among the nodes of the graph it builds.  ``nodes()`` gives the graph's
    node count so far (None where it cannot be read): each span's entry
    and exit marks the count and the stack of open spans, so the nodes
    created between two marks were launched under the first mark's stack.
    A recording belongs to the thread that captures: another thread's
    spans and counts, its own capture's included, do not reach it."""

    def __init__(self, nodes: Callable[[], int | None]):
        self.nodes = nodes
        self.stack: list = []
        self.marks = [(nodes(), ())]
        self.delta: dict = {}

    def enter(self, name: str) -> None:
        self.stack.append(name)
        self.marks.append((self.nodes(), tuple(self.stack)))

    def exit(self) -> None:
        self.stack.pop()
        self.marks.append((self.nodes(), tuple(self.stack)))

    def paths(self, n_nodes: int) -> list | None:
        """The stack of spans (a tuple of names, outermost first) that each
        node created after the first mark, up to the graph's ``n_nodes``-th,
        was created under, in creation order; None when a node count could
        not be read."""
        if any(n is None for n, _ in self.marks):
            return None
        out = []
        for (n, path), (nxt, _) in zip(self.marks,
                                       self.marks[1:] + [(n_nodes, ())]):
            out += [path] * (nxt - n)
        return out


@contextlib.contextmanager
def recording(nodes: Callable[[], int | None]):
    """Record the calling thread's captured pass (see :class:`Recording`);
    yields it.  While it records, the thread's counts go to its ``delta``
    and not to the registry: the capture ran nothing, and each replay adds
    them (:func:`replayed`).  Threads capturing at once (one a device, as
    ``parallel/mesh.py`` runs them) each record their own."""
    if getattr(_LOCAL, "rec", None) is not None:
        raise RuntimeError("profiling: a capture is being recorded already")
    rec = Recording(nodes)
    _LOCAL.rec = rec
    try:
        yield rec
    finally:
        _LOCAL.rec = None


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
