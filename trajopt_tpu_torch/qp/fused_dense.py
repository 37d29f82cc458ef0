"""Fused dense ADMM chunks: the hand-written CUDA kernel
(``csrc/admm_dense_chunk.cu``) and its plain PyTorch version.  The loop
over chunks, the residuals, adaptive rho and Anderson acceleration are
``admm.solve_qp``.

Counterpart of ``trajopt_tpu/qp/pallas_admm.py``: :func:`chunk` runs
``n_iters`` relaxed prox-ADMM iterations on dense QPs, one problem per
lane, on unpadded shapes (the TPU kernel padded to (8, 128) tiles).  It
follows ``admm_iter`` of ``solve_qp`` with ``use_pallas=False``:
``x~ = Minv @ rhs`` (the Pallas body applies ``rhs @ Minv``, which differs
in float32 because the inverse is not exactly symmetric there) and the
carried relaxed ``A x``, which it returns beside x, z and y (the Pallas
path recomputes ``A @ x`` after the call; the two differ only by
rounding).

Dispatch: on CPU tensors :func:`chunk` runs :func:`chunk_plain`; on CUDA
tensors it launches the kernel or raises — there is no fallback.  The
kernel runs one thread-block cluster per problem, of the size
:func:`cluster_plan` picks from the shape, with ``A`` and ``Minv`` split
by rows across the cluster's shared memory; shapes that no cluster of 8
blocks holds take the file's streaming kernel instead, chosen from the
shape before any launch.  It is built with ``nvcc`` for ``sm_90a`` at
first use into ``trajopt_tpu_torch/_build/`` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from trajopt_tpu_torch import kernels

SOURCE = kernels.CSRC / "admm_dense_chunk.cu"
COUNTER = kernels.LaunchCounter()
_LIB = None


def build(verbose: bool = False):
    """Compile the kernel (once per source hash) and return the library
    path; see ``kernels.build_library``."""
    return kernels.build_library(SOURCE, verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.admm_dense_chunk.argtypes = [vp] * 15 + [ci] * 4 + [cf] * 2 \
            + [ci, vp]
        lib.admm_dense_chunk.restype = ci
        lib.admm_dense_chunk_prepare.argtypes = [ci] * 3 \
            + [ctypes.c_size_t, ctypes.POINTER(ci)]
        lib.admm_dense_chunk_prepare.restype = ci
        _LIB = lib
    return _LIB


# The kernel's limits (csrc/admm_dense_chunk.cu: NT, MAX_CS): 512 threads a
# block, one column a thread, clusters of up to 8 blocks.  cluster_plan
# repeats the kernel's shared-memory layouts (cluster_smem_floats and
# stream_smem_floats there); _prepare checks the two agree, once a shape.
THREADS = 512
MAX_N = THREADS
CLUSTER_SIZES = tuple(range(1, 9))


@functools.lru_cache(maxsize=None)
def cluster_plan(n: int, m: int) -> tuple[int, int]:
    """(cs, bytes of shared memory per block) for the dense chunk kernel.
    cs is the least cluster size whose blocks fit in
    ``kernels.SMEM_LIMIT`` when rank r of the cs blocks holds four
    transaction barriers, rows [r mr, (r+1) mr) of A (mr = ceil(m / cs))
    and rows [r nr, (r+1) nr) of Minv (nr = ceil(n / cs)) at a row stride
    of ns = n rounded up to a multiple of 4, the state of its A rows
    ([8, mr], each row rounded up to a multiple of 4), the warps' column
    sums ([16, ns]), the double-buffered xt ([2, ns]), rhs ([ns]) and the
    double-buffered partials ([2, cs, n]).  cs = 0 when no cluster holds the
    shape: the streaming kernel, whose block holds the row state [7, m],
    rhs and xt and the column sums.  Raises ``ValueError`` when n is
    outside the kernel's column range (1..512) or when the streaming
    block does not fit either."""
    if not 0 < n <= MAX_N:
        raise ValueError(f"n={n} outside the kernel's column range "
                         f"(1..{MAX_N})")
    nwarp = THREADS // 32

    def r4(k):
        return -(-k // 4) * 4

    for cs in CLUSTER_SIZES:
        mr, nr = -(-m // cs), -(-n // cs)
        floats = (8 + (mr + nr + nwarp + 3) * r4(n) + 8 * r4(mr)
                  + r4(2 * cs * n))
        if 4 * floats <= kernels.SMEM_LIMIT:
            return cs, 4 * floats
    smem = 4 * (7 * m + 2 * n + nwarp * n)
    if smem > kernels.SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory "
                         f"(> {kernels.SMEM_LIMIT})")
    return 0, smem


@functools.lru_cache(maxsize=None)
def _prepare(device: int, n: int, m: int) -> tuple[int, int]:
    """(cs, problems resident at once) for a shape on CUDA device
    ``device``, once: the C side checks :func:`cluster_plan`'s bytes
    against its own layout, sets the kernel's shared-memory limit and
    queries ``cudaOccupancyMaxActiveClusters`` (for cs = 0 the streaming
    kernel's resident blocks).  Raises when any of that fails or nothing
    can be resident."""
    cs, smem = cluster_plan(n, m)
    out = ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib().admm_dense_chunk_prepare(n, m, cs, smem, out)
    if err != 0:
        raise RuntimeError(f"admm_dense_chunk_prepare failed for n={n}, "
                           f"m={m}, cs={cs}: CUDA error {err}")
    if out.value == 0:
        what = f"cluster of {cs} blocks" if cs else "streaming block"
        raise RuntimeError(f"no {what} with {smem} B of shared memory per "
                           f"block can be resident")
    return cs, out.value


def max_active_clusters(n: int, m: int) -> int:
    """How many problems the current card runs at once for this shape:
    clusters of :func:`cluster_plan`'s size
    (``cudaOccupancyMaxActiveClusters``), or streaming blocks when the
    plan's cs is 0."""
    return _prepare(torch.cuda.current_device(), n, m)[1]


_ARG_NAMES = ("Minv", "A", "q", "l", "u", "cr", "rho", "x", "z", "y")


def chunk_plain(Minv, A, q, l, u, cr, rho, x, z, y, *, sigma, alpha,
                n_iters):
    """Plain PyTorch chunk: ``n_iters`` iterations of ``admm_iter``.
    Shapes: Minv [B,n,n], A [B,m,n], q/x [B,n], l/u/cr/rho/z/y [B,m]
    (``cr = c / rho``, inf on hard rows).  Returns (x, z, y, Ax) with Ax
    the carried relaxed ``A x``."""
    At = A.transpose(-1, -2)
    Ax = (A @ x[..., None])[..., 0]
    for _ in range(n_iters):
        rhs = sigma * x - q + (At @ (rho * z - y)[..., None])[..., 0]
        xt = (Minv @ rhs[..., None])[..., 0]
        zt = (A @ xt[..., None])[..., 0]
        x = alpha * xt + (1.0 - alpha) * x
        Ax = alpha * zt + (1.0 - alpha) * Ax
        zr = alpha * zt + (1.0 - alpha) * z
        v = zr + y / rho
        z_new = torch.where(v > u, torch.maximum(u, v - cr),
                            torch.where(v < l, torch.minimum(l, v + cr), v))
        y = y + rho * (zr - z_new)
        z = z_new
    return x, z, y, Ax


def chunk_flops(A: torch.Tensor, n_iters: int) -> int:
    """Floating-point operations of one chunk: per problem and iteration
    the three dense products ``A'w``, ``Minv rhs`` and ``A x~``
    (2 (2 m n + n^2)) and the elementwise updates (6 per column, 16 per
    row); the chunk's first ``A x`` (2 m n)."""
    B, m, n = A.shape
    per_iter = 2 * (2 * m * n + n * n) + 6 * n + 16 * m
    return B * (n_iters * per_iter + 2 * m * n)


def chunk_bytes(A: torch.Tensor) -> int:
    """Bytes one chunk must move at the least: every input read once and
    every output written once, in float32."""
    B, m, n = A.shape
    return 4 * B * (n * n + m * n + 2 * n + 6 * m + n + 3 * m)


def chunk_stream_bytes(A: torch.Tensor, n_iters: int) -> int:
    """Bytes of ``A`` and ``Minv`` one chunk's iterations read: ``A`` once
    per iteration and once before the first, ``Minv`` once per iteration.
    The streaming kernel, which takes the shapes no cluster holds
    (:func:`cluster_plan` gives cs = 0), reads them from device memory;
    the cluster kernel reads the same bytes from shared memory."""
    B, m, n = A.shape
    return 4 * B * ((n_iters + 1) * m * n + n_iters * n * n)


def chunk_cuda(Minv, A, q, l, u, cr, rho, x, z, y, *, sigma, alpha, n_iters,
               active=None):
    """Launch the kernel on the current stream, one cluster of
    :func:`cluster_plan`'s size per problem (one streaming block when it
    is 0).  ``active`` [B] bool skips lanes (their outputs are left
    unwritten; :func:`chunk` masks them)."""
    args = (Minv, A, q, l, u, cr, rho, x, z, y)
    B, m, n = A.shape
    shapes = {"Minv": (B, n, n), "A": (B, m, n), "q": (B, n), "x": (B, n)}
    for name in ("l", "u", "cr", "rho", "z", "y"):
        shapes[name] = (B, m)
    dev = A.device
    for name, t in zip(_ARG_NAMES, args):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    cs, _ = _prepare(dev.index, n, m)
    outs = [torch.empty_like(t) for t in (x, z, y, z)]
    act = None
    if active is not None:
        act = active.to(device=dev, dtype=torch.int32).contiguous()
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().admm_dense_chunk(
            *[t.data_ptr() for t in args], *[o.data_ptr() for o in outs],
            None if act is None else act.data_ptr(), B, m, n, cs,
            float(sigma), float(alpha), int(n_iters), stream)
        if err != 0:
            raise RuntimeError(f"admm_dense_chunk launch failed: CUDA error "
                               f"{err}")
        COUNTER.launches += 1
    return tuple(outs)


def chunk(*args, sigma, alpha, n_iters, active=None):
    """One fused chunk (see module doc): (x, z, y, Ax).  CPU tensors take
    the plain version; CUDA tensors launch the kernel.  With ``active``
    [B] bool, inactive lanes return their input x, z, y unchanged and a
    NaN ``Ax``."""
    dev = args[0].device
    if dev.type == "cpu":
        out = chunk_plain(*args, sigma=sigma, alpha=alpha, n_iters=n_iters)
    elif dev.type == "cuda":
        out = chunk_cuda(*args, sigma=sigma, alpha=alpha, n_iters=n_iters,
                         active=active)
    else:
        raise ValueError(f"no chunk implementation for device {dev}")
    if active is None:
        return out
    keep = active[:, None]
    x, z, y = (torch.where(keep, new, old)
               for new, old in zip(out[:3], args[7:]))
    return x, z, y, torch.where(keep, out[3], torch.full_like(out[3],
                                                              float("nan")))
