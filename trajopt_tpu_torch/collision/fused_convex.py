"""The convex narrowphase's discrete search: the hand-written CUDA kernel
(``csrc/convex_narrowphase.cu``) and its plain PyTorch version.

:func:`select` takes a batch of posed vertex sets ``Va [..., A, 3]``,
``Vb [..., B, 3]``, the caller's candidate axes ``axes [..., K, 3]`` with
their mask ``valid [..., K]`` and the centroid axis ``cax [..., 3]``, and
returns a :class:`Selection`: GJK's best simplex (``collision/convex.py``
``_gjk_slots``), the witness vector ``z`` it spans, and the SAT winner over
the K caller axes, the centroid axis and ``z`` (``_sat_select``).  Nothing
of it carries a gradient; ``convex._epilogue`` recomputes the distance
from the selected indices with autograd.

Counterpart of the search inside ``trajopt_tpu/collision/convex.py``
``convex_convex``, which has no Pallas source: XLA fuses it on the TPU.

Dispatch: on CPU tensors :func:`select` runs :func:`select_plain`; on CUDA
tensors it launches the kernel (one thread a query, several queries a
thread; a query's GJK stops at its fixed point, where a step returns the
simplex and weights bit for bit; compile-time instantiations for the
vertex counts the paths run, a run-time one for any other count) or
raises -- there is no fallback.  The kernel is built with ``nvcc`` for
``sm_90a`` at first use into ``trajopt_tpu_torch/_build/``, with
``--fmad=false`` so that only the fused multiply-adds the plain version
makes (``torch.addcmul``) are fused, and bound with ``ctypes``.  Broadcast inputs (stride 0) are read through
their strides, not copied.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from trajopt_tpu_torch import kernels
from trajopt_tpu_torch.collision import convex as cvx

SOURCE = kernels.CSRC / "convex_narrowphase.cu"
FLAGS = [*kernels.NVCC_FLAGS, "--fmad=false"]
COUNTER = kernels.LaunchCounter()
KERNEL = "convex_select_kernel"      # the kernel's name in a profile
MAX_DIMS = 4                         # batch dims the kernel indexes
_DTYPES = {torch.float32: 0, torch.float64: 1}
_LIB = None


class Selection(NamedTuple):
    """The search's result for a batch of queries ``[...]``."""
    idA: torch.Tensor      # [..., 4] long: GJK's best simplex, a's vertices
    idB: torch.Tensor      # [..., 4] long: b's vertices
    lam: torch.Tensor      # [..., 4]: its barycentric weights
    z: torch.Tensor        # [..., 3]: the witness vector, the last SAT axis
    k: torch.Tensor        # [..., 1] long: the winning axis of [axes, cax, z]
    flip: torch.Tensor     # [..., 1] bool: a lies above b along it
    ia: torch.Tensor       # [..., 1] long: a's extreme vertex on it
    ib: torch.Tensor       # [..., 1] long: b's extreme vertex on it


def build(verbose: bool = False):
    """Compile the kernel (once per source hash) and return the library
    path; see ``kernels.build_library``."""
    return kernels.build_library(SOURCE, verbose, flags=FLAGS)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp = ctypes.c_void_p
        lib.convex_select.argtypes = [ctypes.c_int] + [vp] * 5 \
            + [ctypes.POINTER(ctypes.c_longlong)] + [vp] * 9
        lib.convex_select.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@torch.no_grad()
def select_plain(Va, Vb, axes, valid, cax, iters: int = cvx.GJK_ITERS):
    """Plain PyTorch search (see module doc) on tensors of one batch
    shape."""
    idA, idB, lam = cvx._gjk_slots(Va, Vb, iters)
    z = cvx._witness(Va, idA, lam) - cvx._witness(Vb, idB, lam)
    extra = torch.ones((*valid.shape[:-1], 2), dtype=torch.bool,
                       device=valid.device)
    k, flip, ia, ib = cvx._sat_select(Va, Vb, cvx._all_axes(axes, cax, z),
                                      torch.cat([valid, extra], -1))
    return Selection(idA, idB, lam, z, k, flip, ia, ib)


def _batch_layout(batch, tensors):
    """(sizes, strides per tensor) of the batch dims after dropping size-1
    dims and merging neighbours that every tensor steps through as one
    (stride-0 broadcast dims stay stride 0).  Raises ``ValueError`` past
    :data:`MAX_DIMS` dims."""
    dims = [(n, [t.stride(d) for t in tensors])
            for d, n in enumerate(batch) if n != 1]
    merged = []
    for n, st in dims:
        if merged and all(a == b * n for a, b in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * n, st)
        else:
            merged.append((n, st))
    if len(merged) > MAX_DIMS:
        raise ValueError(f"batch {tuple(batch)} needs {len(merged)} strided "
                         f"dims; the kernel indexes at most {MAX_DIMS}")
    return [n for n, _ in merged], [[st[i] for _, st in merged]
                                    for i in range(len(tensors))]


def select_flops(A: int, B: int, K: int, iters: int = cvx.GJK_ITERS) -> int:
    """Floating-point operations of one query as the kernel computes it (a
    fused multiply-add counted as 2; divisions and square roots as 1;
    comparisons and selects not counted).  Per GJK step: the iterate z
    (21), the support dot products (5 each of A + B vertices), the
    duplicate merge (6), the new simplex row (3), the Gram matrix (10 dot
    products, 50), and for each of the 15 subsets the ridge (4), the 4x4
    Cholesky solve (62), the
    weights (4 products, 3 adds, 4 divisions), their point (21) and its
    norm (5); then the best iterate's norm (26).  The witness (2 x 21 +
    3) and for each of the K + 2 SAT axes its norm (7), the A + B
    projections (5 each) and its two gaps (4); the winner's projections
    again (5 (A + B))."""
    per_subset = 4 + 62 + 11 + 21 + 5
    per_step = 21 + 5 * (A + B) + 6 + 3 + 50 + 15 * per_subset + 26
    return (26 + iters * per_step + 45 + (K + 2) * (11 + 5 * (A + B))
            + 5 * (A + B))


@torch.no_grad()
def gjk_steps(Va, Vb, iters: int = cvx.GJK_ITERS) -> torch.Tensor:
    """The GJK steps the kernel runs for each query ``[...]`` (long): up
    to and including the first step that returns the slots and weights
    bit for bit as they went in (the query's fixed point, where the kernel
    stops it), at most ``iters``.  Plain PyTorch on any device, launching
    nothing: the data-dependent count behind :func:`search_flops`."""
    A, B = Va.detach(), Vb.detach()
    idA, idB, lam = cvx._gjk_start(A, B)
    slots = torch.arange(4, device=A.device)
    bits = torch.int32 if lam.dtype == torch.float32 else torch.int64
    steps = torch.full(A.shape[:-2], iters, dtype=torch.long, device=A.device)
    for i in range(iters):
        nA, nB, nl, _ = cvx._gjk_step(A, B, idA, idB, lam, slots)
        same = ((nA == idA) & (nB == idB)
                & (nl.view(bits) == lam.view(bits))).all(-1)
        steps = torch.where(same & (steps == iters), i + 1, steps)
        idA, idB, lam = nA, nB, nl
    return steps


def search_flops(A: int, B: int, K: int, steps: torch.Tensor) -> int:
    """:func:`select_flops` summed over queries that run ``steps`` GJK
    steps each (:func:`gjk_steps`): the operations a call's data needs."""
    per_step = select_flops(A, B, K, 1) - select_flops(A, B, K, 0)
    return steps.numel() * select_flops(A, B, K, 0) \
        + int(steps.sum()) * per_step


def select_bytes(Va, Vb, axes, valid, cax) -> int:
    """Bytes the search must move: each input element read once (a
    broadcast dim's repeats not counted) and each output written once."""
    def unique(t):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n * t.element_size()

    N = cax[..., 0].numel()
    out = N * ((2 * 4 + 3) * 8 + (4 + 3) * Va.element_size() + 1)
    return sum(unique(t) for t in (Va, Vb, axes, valid, cax)) + out


def _outputs(batch, dtype, dev) -> Selection:
    """An uninitialised :class:`Selection` for ``batch`` queries."""
    i64 = dict(dtype=torch.long, device=dev)
    return Selection(
        idA=torch.empty(*batch, 4, **i64), idB=torch.empty(*batch, 4, **i64),
        lam=torch.empty(*batch, 4, dtype=dtype, device=dev),
        z=torch.empty(*batch, 3, dtype=dtype, device=dev),
        k=torch.empty(*batch, 1, **i64),
        flip=torch.empty(*batch, 1, dtype=torch.bool, device=dev),
        ia=torch.empty(*batch, 1, **i64), ib=torch.empty(*batch, 1, **i64))


def select_cuda(Va, Vb, axes, valid, cax, iters: int = cvx.GJK_ITERS):
    """Launch the kernel on the current stream, one thread a query, on
    tensors of one batch shape (any strides); returns a
    :class:`Selection` of contiguous tensors."""
    batch = Va.shape[:-2]
    A, B, K = Va.shape[-2], Vb.shape[-2], axes.shape[-2]
    shapes = {"Va": (*batch, A, 3), "Vb": (*batch, B, 3),
              "axes": (*batch, K, 3), "valid": (*batch, K),
              "cax": (*batch, 3)}
    args = {"Va": Va, "Vb": Vb, "axes": axes, "valid": valid, "cax": cax}
    dev = Va.device
    if Va.dtype not in _DTYPES:
        raise TypeError(f"Va: expected float32 or float64, got {Va.dtype}")
    for name, t in args.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}")
        want = torch.bool if name == "valid" else Va.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    if A == 0 or B == 0:
        raise ValueError("Va and Vb need at least one vertex")
    ts = list(args.values())
    sizes, strides = _batch_layout(batch, ts)
    nd = len(sizes)
    pad = MAX_DIMS - nd
    lay = [cax[..., 0].numel(), nd, *sizes, *[1] * pad]
    for st in strides:
        lay += [*st, *[0] * pad]
    lay += [Va.stride(-2), Va.stride(-1), Vb.stride(-2), Vb.stride(-1),
            axes.stride(-2), axes.stride(-1), valid.stride(-1),
            cax.stride(-1), A, B, K, int(iters)]
    out = _outputs(batch, Va.dtype, dev)
    if lay[0]:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().convex_select(
            _DTYPES[Va.dtype], *[t.data_ptr() for t in ts],
            (ctypes.c_longlong * len(lay))(*lay),
            *[t.data_ptr() for t in out], stream)
        if err != 0:
            raise RuntimeError(f"convex_select launch failed: CUDA error "
                               f"{err}")
        COUNTER.launches += 1
    return out


def select(Va, Vb, axes, valid, cax, iters: int = cvx.GJK_ITERS):
    """The search (see module doc).  CPU tensors take the plain version;
    CUDA tensors launch the kernel; meta tensors (shapes only: a problem
    checks its terms' row counts on them) get the outputs' shapes; any
    other device raises."""
    dev = Va.device
    if dev.type == "meta":
        return _outputs(Va.shape[:-2], Va.dtype, dev)
    if dev.type == "cpu":
        return select_plain(Va, Vb, axes, valid, cax, iters)
    if dev.type == "cuda":
        return select_cuda(Va, Vb, axes, valid, cax, iters)
    raise ValueError(f"no convex search for device {dev}")
