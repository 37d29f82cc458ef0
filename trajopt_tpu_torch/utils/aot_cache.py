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
"""

from __future__ import annotations

import contextlib
import hashlib
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

PKG = Path(__file__).resolve().parents[1]
_SOURCE_SUFFIXES = (".py", ".cu", ".cpp", ".cuh", ".h")


class CaptureStats:
    """Counts of captures, their seconds, and replays (for reports; the
    counts cover every ``cached_export`` callable of the process)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

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
        with torch.cuda.graph(graph, pool=self.pool, stream=s,
                              capture_error_mode="thread_local"):
            out = self.fn(*args)
        self.static_out, self.out_spec = flatten(out)
        self.graph = graph
        dt = time.perf_counter() - t0
        STATS.captures += 1
        STATS.capture_s += dt
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
        self.graph.replay()
        STATS.replays += 1
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
