"""Capture once, replay: fixed-shape regions of the solver as CUDA graphs.

Counterpart of ``trajopt_tpu/utils/aot_cache.py``.  The JAX module removes
the cost of re-staging the solver's program: it traces once, keys the
program by ``key | shapes | jax version | platform | source hash`` and
replays it.  Eager PyTorch has no trace step; it pays the Python staging on
every call instead, dispatching every op of a region again.  So here a
region is captured once, at its shapes, as a CUDA graph (``torch.cuda.graph``)
and every later call copies its arguments into the graph's static inputs
and replays the recorded launches: the region runs as one program, as a
jitted function does.

:func:`cached_export` memoises the capture in the process under the JAX
module's key, ``key | the tree of shapes and dtypes | torch version |
device | source hash``, where the tree also holds the values of the
arguments' non-tensor leaves (a capture freezes them); the key must name
every other knob that shapes the region (solver settings, workload sizes)
unless the memo is the region owner's own.

There is no disk artifact.  A CUDA graph holds device addresses, and
nothing of a capture survives its process; the port's one compile step,
the kernel build, already caches by source hash (``kernels.build_library``).
So the function takes no ``cache_dir``.

On CPU tensors there is nothing to capture and :func:`cached_export`
returns ``fn`` itself.  On CUDA tensors a capture that fails raises: it
never carries on eager.  Under :func:`eager` (the counterpart of
``jax.disable_jit``) the callables run ``fn`` eagerly, so a run can hold
the captured path against the eager one in one process.

:func:`bucket` and :func:`pad_lanes` / :func:`take_lanes` keep the number
of captures small for regions called on a shrinking set of live lanes: a
region called on ``k`` lanes runs at the next power of two, capped at the
full batch, padded by repeats of its first lane.

Every capture records its graph's node map (:func:`node_maps`): the span
of ``utils/profiling.py`` that each traced node (kernel, copy, memset) was
launched under, in the order the replay runs them, since a captured
region's spans do not run again on replay.  Each replay runs inside the
span ``<key>.replay.<n>`` (``n`` numbers the process's graphs), which names
the map of the graph it launches, and adds the counts of the captured pass
to the counter registry.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import itertools
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from trajopt_tpu_torch.utils import profiling

PKG = Path(__file__).resolve().parents[1]
_SOURCE_SUFFIXES = (".py", ".cu", ".cpp", ".cuh", ".h")


class CaptureStats:
    """Counts of captures, their seconds, and replays over every
    ``cached_export`` callable of the process since :meth:`reset`, read
    from the port's counter registry (``utils/profiling.py``:
    ``capture.captures``, ``capture.seconds``, ``capture.replays``).
    :meth:`reset` clears nothing: it keeps a snapshot of the registry, and
    the counts are read less it (from the registry's own
    ``profiling.reset()`` where that came later).

    :meth:`since_reset` reads every counter so, and is a stop-gap:
    ``port_bench/run.py`` marks its measured window only by
    ``STATS.reset()``, so the benchmark's counter readers read the window
    through it, until ``run.py`` snapshots ``profiling.counters()`` at the
    window's edges itself."""

    def __init__(self):
        self._base = (None, {})             # (profiling.resets(), counts)

    def since_reset(self) -> dict:
        """Every counter of the registry less its count at the later of
        :meth:`reset` and ``profiling.reset()``."""
        resets, base = self._base
        now = profiling.counters()
        if resets != profiling.resets():
            return now
        return {name: n - base.get(name, 0) for name, n in now.items()}

    @property
    def captures(self) -> int:
        return self.since_reset().get("capture.captures", 0)

    @property
    def capture_s(self) -> float:
        return self.since_reset().get("capture.seconds", 0.0)

    @property
    def replays(self) -> int:
        return self.since_reset().get("capture.replays", 0)

    def reset(self):
        self._base = (profiling.resets(), profiling.counters())

    def __repr__(self):
        return (f"captures {self.captures}, capture seconds "
                f"{self.capture_s:.3f}, replays {self.replays}")


STATS = CaptureStats()
_MEMO: dict = {}
_LOCK = threading.Lock()
_EAGER = [0]
_EPOCH = [0]
_STREAMS: dict = {}
_HASH: dict = {}
_GRAPH_IDS = itertools.count()
_NODE_MAPS: dict = {}
_CU: dict = {}
# CUgraphNodeType values of the nodes a profiler traces on replay
_TRACED = {0: "kernel", 1: "memcpy", 2: "memset"}


class NodeMap(NamedTuple):
    """The traced nodes of one captured graph in creation order, which a
    single-stream capture runs them in: each one's kind (``"kernel"``,
    ``"memcpy"``, ``"memset"``) and the stack of spans it was launched
    under (outermost first; ``()`` outside every span of the region)."""
    kinds: tuple
    paths: tuple


def node_maps() -> dict:
    """{replay span name: :class:`NodeMap`} of every graph captured in the
    process whose nodes could be read."""
    return dict(_NODE_MAPS)


def _libcuda():
    """``libcuda.so.1`` with the capture queries' signatures, or None where
    it cannot be loaded or lacks one of them."""
    if "lib" not in _CU:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            p = ctypes.c_void_p
            for fn, n_args in ((lib.cuStreamGetCaptureInfo_v2, 6),
                               (lib.cuGraphGetNodes, 3),
                               (lib.cuGraphNodeGetType, 2)):
                fn.argtypes = [p] * n_args
                fn.restype = ctypes.c_int
        except (OSError, AttributeError):
            lib = None
        _CU["lib"] = lib
    return _CU["lib"]


def _capture_nodes(stream: torch.cuda.Stream) -> list | None:
    """The nodes (``CUgraphNode`` handles) of the graph that ``stream`` is
    capturing into, in creation order; None where they cannot be read."""
    lib = _libcuda()
    if lib is None:
        return None
    status, ident, graph = ctypes.c_int(), ctypes.c_uint64(), \
        ctypes.c_void_p()
    err = lib.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
        ctypes.byref(ident), ctypes.byref(graph), None, None)
    if err != 0 or status.value != 1:           # CU_STREAM_CAPTURE_ACTIVE
        return None
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        return None
    return list(nodes)[:n.value]


def _node_kinds(nodes: list) -> list | None:
    """Each node's traced kind (None for a node a profiler does not see)."""
    lib, kind = _libcuda(), ctypes.c_int()
    out = []
    for node in nodes:
        if lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                  ctypes.byref(kind)) != 0:
            return None
        out.append(_TRACED.get(kind.value))
    return out


def _record_map(name: str, rec: profiling.Recording, nodes: list | None):
    """Keep the node map of the graph captured under ``rec`` (its nodes
    ``nodes`` at the capture's end) as ``name``'s."""
    kinds = None if nodes is None else _node_kinds(nodes)
    paths = None if kinds is None else rec.paths(len(kinds))
    if paths is None:
        return
    traced = [(k, p) for k, p in zip(kinds[rec.marks[0][0]:], paths)
              if k is not None]
    _NODE_MAPS[name] = NodeMap(tuple(k for k, _ in traced),
                               tuple(p for _, p in traced))


def _source_hash(root: Path | None = None) -> str:
    """Content hash of every ``.py`` of the port and every kernel source of
    its ``csrc/`` (a capture must never outlive a code change).  Computed
    once per process for the installed package."""
    root = PKG if root is None else Path(root)
    if root in _HASH:
        return _HASH[root]
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix in _SOURCE_SUFFIXES \
                and "_build" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    digest = h.hexdigest()[:16]
    if root == PKG:
        _HASH[root] = digest
    return digest


def capture_epoch() -> int:
    """A count of the warm-ups and captures begun in the process: a memo of
    results by input tensor (``ifopt._Group``) must not carry a result
    across it, since a capture's static input is the same tensor as its
    warm-up's."""
    return _EPOCH[0]


@contextlib.contextmanager
def eager():
    """Within this context every :func:`cached_export` callable runs its
    function eagerly (no capture, no replay); contexts nest.  Process-wide,
    like ``jax.disable_jit``."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def _flatten(tree, leaves: list):
    """Tensor leaves of nested tuples, named tuples, lists and dicts, in
    order, and the tree's spec (other leaves are kept in the spec)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, (tuple, list)):
        return (type(tree), [_flatten(t, leaves) for t in tree])
    if isinstance(tree, dict):
        return (dict, [(k, _flatten(v, leaves)) for k, v in tree.items()])
    return ("leaf", tree)


def unflatten(spec, leaves):
    """The tree of :func:`flatten`'s ``spec`` with ``leaves`` for its
    tensor leaves."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, body = s
        if kind == "leaf":
            return body
        if kind is dict:
            return {k: build(v) for k, v in body}
        parts = [build(v) for v in body]
        return kind(*parts) if hasattr(kind, "_fields") else kind(parts)
    return build(spec)


def flatten(tree) -> tuple[list, Any]:
    """(tensor leaves, spec) of ``tree``; :func:`unflatten` inverts it."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _shapes(leaves) -> str:
    return ";".join(f"{tuple(t.shape)}:{t.dtype}" for t in leaves)


def _leaf_key(v) -> str:
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        return (f"{a.dtype.str}{a.shape}:"
                f"{hashlib.sha256(a.tobytes()).hexdigest()[:16]}")
    return repr(v)


def static_key(spec) -> str:
    """The tree of ``spec`` with its non-tensor leaves' values (arrays by
    content): a capture freezes those values into the graph, so they name
    it as the tensors' shapes do."""
    if spec is None:
        return "T"
    kind, body = spec
    if kind == "leaf":
        return _leaf_key(body)
    if kind is dict:
        return "{" + ",".join(f"{k!r}:{static_key(v)}" for k, v in body) \
            + "}"
    return f"{kind.__name__}(" + ",".join(map(static_key, body)) + ")"


def _device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return dev.type
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda:{idx} {torch.cuda.get_device_name(idx)}"


def _ident(key: str, leaves, spec, dev: torch.device) -> str:
    """The memo key: ``key | the tree (tensors' shapes and dtypes, other
    leaves' values) | torch version | device | source hash``."""
    return "|".join([key, _shapes(leaves), static_key(spec),
                     torch.__version__, _device_name(dev), _source_hash()])


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """One side stream a device for warm-ups and captures, so the cuBLAS
    workspaces made in the warm-up are the capture's."""
    with _LOCK:
        if dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(dev)
        return _STREAMS[dev]


class _Graphed:
    """``fn`` at fixed shapes on one CUDA device: captured at its first
    call outside :func:`eager`, replayed after."""

    def __init__(self, fn: Callable, leaves, spec, name: str, pool,
                 verbose: bool):
        self.fn, self.spec, self.name = fn, spec, name
        self.shapes = [(tuple(t.shape), t.dtype) for t in leaves]
        self.static = static_key(spec)
        self.dev = leaves[0].device
        self.pool, self.verbose = pool, verbose
        self.graph = None
        self.delta: dict = {}       # what a replay adds to the counters
        self.replay_span = f"{name.split('|')[0]}.replay.{next(_GRAPH_IDS)}"

    def _check(self, leaves, spec):
        got = [(tuple(t.shape), t.dtype) for t in leaves]
        if got != self.shapes or any(t.device != self.dev for t in leaves):
            raise ValueError(f"aot_cache: {self.name} was exported for "
                             f"{self.shapes} on {self.dev}, called with "
                             f"{got}")
        if static_key(spec) != self.static:
            raise ValueError(f"aot_cache: {self.name} was exported for "
                             f"other non-tensor arguments: "
                             f"{static_key(spec)} against {self.static}")

    def _capture(self, leaves):
        t0 = time.perf_counter()
        self.static_in = [t.detach().clone() for t in leaves]
        args = unflatten(self.spec, self.static_in)
        s = _capture_stream(self.dev)
        cur = torch.cuda.current_stream(self.dev)
        s.wait_stream(cur)
        _EPOCH[0] += 1
        with torch.cuda.stream(s):
            self.fn(*args)                      # warm-up: caches, handles
        cur.wait_stream(s)
        _EPOCH[0] += 1
        graph = torch.cuda.CUDAGraph()

        def n_nodes():
            nodes = _capture_nodes(s)
            return None if nodes is None else len(nodes)

        with torch.cuda.graph(graph, pool=self.pool, stream=s,
                              capture_error_mode="thread_local"):
            with profiling.recording(n_nodes) as rec:
                out = self.fn(*args)
            nodes = _capture_nodes(s)
        self.static_out, self.out_spec = flatten(out)
        self.graph = graph
        self.delta = rec.delta
        _record_map(self.replay_span, rec, nodes)
        dt = time.perf_counter() - t0
        profiling.count("capture.captures")
        profiling.count("capture.seconds", dt)
        if self.verbose:
            print(f"# aot_cache: captured {self.name} in {dt:.3f} s",
                  file=sys.stderr)

    def __call__(self, *args):
        leaves, spec = flatten(args)
        self._check(leaves, spec)
        if _EAGER[0]:
            return self.fn(*args)
        if self.graph is None:
            self._capture(leaves)
        else:
            for dst, src in zip(self.static_in, leaves):
                dst.copy_(src)
        with profiling.span(self.replay_span):
            self.graph.replay()
        profiling.replayed(self.delta)
        profiling.count("capture.replays")
        # Another replay overwrites the static outputs: hand out copies.
        return unflatten(self.out_spec, [t.clone() for t in self.static_out])


def cached_export(fn: Callable, example_args: tuple, key: str,
                  verbose: bool = False, pool=None, memo: dict | None = None):
    """A callable equal to ``fn`` specialised to ``example_args``' shapes
    and dtypes (a tree of tensors) and to the values of its other leaves
    (numbers, arrays, None); it raises on others, as an exported JAX
    program does.

    On CUDA tensors its first call outside :func:`eager` warms ``fn`` up
    once on a side stream and captures it as a CUDA graph into static
    input and output buffers, in the memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` its callables share; default a
    private one); each call copies its arguments into the static inputs,
    replays the graph and returns copies of the outputs.  ``fn`` must read
    every tensor that varies between calls from its arguments (anything
    else is frozen into the graph) and must not sync with the host.  On
    CPU tensors it returns ``fn``.

    Callables are memoised in ``memo`` (default: the module's) under
    ``key | shapes and dtypes (and the other leaves' values) | torch
    version | device | source hash``; the same key and tree return the
    same callable."""
    leaves, spec = flatten(tuple(example_args))
    if not leaves:
        raise ValueError("aot_cache: example_args hold no tensor")
    dev = leaves[0].device
    name = _ident(key, leaves, spec, dev)
    memo = _MEMO if memo is None else memo
    with _LOCK:
        if name not in memo:
            memo[name] = (fn if dev.type != "cuda"
                          else _Graphed(fn, leaves, spec, name, pool,
                                        verbose))
        return memo[name]


def bucket(k: int, B: int) -> int:
    """The lane count a region called on ``k`` live lanes of a batch of
    ``B`` runs at: the next power of two >= k, capped at B (at most
    log2(B) + 1 sizes)."""
    if not 1 <= k <= B:
        raise ValueError(f"bucket: {k} lanes of a batch of {B}")
    return min(1 << (k - 1).bit_length(), B)


def pad_lanes(tree, b: int):
    """Every tensor leaf of ``tree`` (leading lane axis of size k <= b)
    padded to ``b`` lanes by repeats of its first lane: finite data, as
    the live lanes hold, and lanes stay independent."""
    def pad(t):
        k = t.shape[0]
        if k == b:
            return t
        return torch.cat([t, t[:1].expand(b - k, *t.shape[1:])])
    leaves, spec = flatten(tree)
    return unflatten(spec, [pad(t) for t in leaves])


def take_lanes(tree, k: int):
    """The first ``k`` lanes of every tensor leaf of ``tree`` (drops the
    pad rows of :func:`pad_lanes`)."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [t if t.shape[0] == k else t[:k]
                            for t in leaves])
