"""Fused block-banded ADMM chunks: the hand-written CUDA kernel
(``csrc/admm_block_chunk.cu``) and its plain PyTorch version.  The loop
over chunks is ``admm_block.solve_qp_block_prepared``.

Counterpart of ``trajopt_tpu/qp/pallas_block.py``.  :func:`chunk` runs
``check_every`` relaxed prox-ADMM iterations and returns the OSQP residual
statistics, the function of ``_chunk_and_check`` there, but on the
``[T, R, K*D]`` windows and ``[T*R]`` block row order of
``block_banded.py`` (the slot-major layout and one-hot segment matmuls of
the TPU kernel existed only for Mosaic).

Dispatch: on CPU tensors :func:`chunk` runs :func:`chunk_plain`; on CUDA
tensors it launches the kernel or raises — there is no fallback.  The
kernel runs one thread-block cluster per problem, of the size
:func:`cluster_plan` picks, with ``Minv`` split across the cluster's shared
memory.  It is built with ``nvcc`` for ``sm_90a`` at first use into
``trajopt_tpu_torch/_build/`` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from trajopt_tpu_torch import kernels
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.utils import profiling

SOURCE = kernels.CSRC / "admm_block_chunk.cu"
_LIB = None


class ChunkStats(NamedTuple):
    pri: torch.Tensor
    dua: torch.Tensor
    ax_n: torch.Tensor
    z_n: torch.Tensor
    pAty_n: torch.Tensor


def build(verbose: bool = False):
    """Compile the kernel (once per source hash) and return the library
    path; see ``kernels.build_library``."""
    return kernels.build_library(SOURCE, verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.admm_block_chunk.argtypes = [vp] * 27 + [ci] * 6 + [cf] * 3 \
            + [ci, vp]
        lib.admm_block_chunk.restype = ci
        lib.admm_block_chunk_prepare.argtypes = [ci] * 5 \
            + [ctypes.c_size_t, ctypes.POINTER(ci)]
        lib.admm_block_chunk_prepare.restype = ci
        _LIB = lib
    return _LIB


# The kernel's limits (csrc/admm_block_chunk.cu: NT, MAX_ROWS, MAX_CS): 512
# threads a block, one column and up to four rows of C a thread, clusters
# of up to 8 blocks.  cluster_plan repeats the kernel's shared-memory
# layout (smem_floats there); _prepare checks the two agree, once a shape.
THREADS = 512
MAX_N, MAX_M = THREADS, 4 * THREADS
CLUSTER_SIZES = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def cluster_plan(T: int, D: int, K: int, R: int) -> tuple[int, int]:
    """(cs, bytes of shared memory per block): the least cluster size whose
    blocks fit in ``kernels.SMEM_LIMIT`` when each of the cs blocks holds
    two transaction barriers, ceil(n / cs) rows of Minv, a full copy of the
    banded weights ([T*R, K*D | 1] floats), w [T*R], the two rhs halves
    and the two xt buffers ([2, n] each) and the reduction scratch, each
    region starting on a 16-byte boundary.  Raises ``ValueError`` when
    n = T*D or m = T*R exceed what the kernel's threads own, or when no
    size fits."""
    n, m, kdp = T * D, T * R, (K * D) | 1
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"n={n}, m={m} exceed the kernel's per-thread "
                         f"ownership (n <= {MAX_N}, m <= {MAX_M})")

    def r4(k):
        return -(-k // 4) * 4

    for cs in CLUSTER_SIZES:
        floats = (4 + r4(-(-n // cs) * n) + r4(m * kdp) + r4(m)
                  + 2 * r4(2 * n) + (THREADS // 32) * 5
                  + CLUSTER_SIZES[-1] * 5)
        if 4 * floats <= kernels.SMEM_LIMIT:
            return cs, 4 * floats
    raise ValueError(f"no cluster of up to {CLUSTER_SIZES[-1]} blocks holds "
                     f"T={T}, D={D}, K={K}, R={R}: a block would need "
                     f"{4 * floats} B of shared memory (> "
                     f"{kernels.SMEM_LIMIT})")


@functools.lru_cache(maxsize=None)
def _prepare(device: int, T: int, D: int, K: int, R: int) -> tuple[int, int]:
    """(cs, resident clusters) for a shape on CUDA device ``device``, once:
    the C side checks :func:`cluster_plan`'s bytes against its own layout,
    sets the kernel's shared-memory limit and queries
    ``cudaOccupancyMaxActiveClusters``.  Raises when any of that fails or
    no cluster can be resident."""
    cs, smem = cluster_plan(T, D, K, R)
    out = ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib().admm_block_chunk_prepare(T, D, K, R, cs, smem, out)
    if err != 0:
        raise RuntimeError(f"admm_block_chunk_prepare failed for T={T}, "
                           f"D={D}, K={K}, R={R}, cs={cs}: CUDA error {err}")
    if out.value == 0:
        raise RuntimeError(f"no cluster of {cs} blocks with {smem} B of "
                           f"shared memory each can be resident")
    return cs, out.value


def max_active_clusters(T: int, D: int, K: int, R: int) -> int:
    """How many clusters of :func:`cluster_plan`'s size the current card can
    hold at once for this shape (``cudaOccupancyMaxActiveClusters``); the
    launch raises when it is 0."""
    return _prepare(torch.cuda.current_device(), T, D, K, R)[1]


_ARG_NAMES = ("Minv", "Wb", "P", "q", "lc", "uc", "cr", "rho_c", "lb", "ub",
              "bd", "Ec", "Eb", "Dd", "cobj", "x", "zc", "zb", "yc", "yb")


def chunk_plain(Minv, Wb, P, q, lc, uc, cr, rho_c, lb, ub, bd, Ec, Eb, Dd,
                cobj, x, zc, zb, yc, yb, *, D, sigma, alpha, rho_b, n_iters):
    """Plain PyTorch chunk: ``n_iters`` iterations then the statistics.
    Shapes: Minv/P [B,n,n], Wb [B,T,R,K*D], row vectors [B,T*R], column
    vectors [B,n], cobj [B]; rho_b is the uniform box-row rho."""
    inv_rho_c = 1.0 / rho_c
    inv_rho_b = 1.0 / rho_b
    for _ in range(n_iters):
        rhs = (sigma * x - q + bb.rmatvec_wb(Wb, rho_c * zc - yc, D)
               + bd * (rho_b * zb - yb))
        xt = (Minv @ rhs[..., None])[..., 0]
        ztc = bb.matvec_wb(Wb, xt, D)
        ztb = bd * xt
        x = alpha * xt + (1.0 - alpha) * x
        zrc = alpha * ztc + (1.0 - alpha) * zc
        zrb = alpha * ztb + (1.0 - alpha) * zb
        v = zrc + yc * inv_rho_c
        zc_new = torch.where(v > uc, torch.maximum(uc, v - cr),
                             torch.where(v < lc, torch.minimum(lc, v + cr),
                                         v))
        zb_new = torch.minimum(ub, torch.maximum(lb, zrb + yb * inv_rho_b))
        yc = yc + rho_c * (zrc - zc_new)
        yb = yb + rho_b * (zrb - zb_new)
        zc, zb = zc_new, zb_new

    def inf(v):
        return torch.amax(torch.abs(v), -1)

    Cx = bb.matvec_wb(Wb, x, D)
    Bx = bd * x
    Px = (P @ x[..., None])[..., 0]
    Aty = bb.rmatvec_wb(Wb, yc, D) + bd * yb
    inv_cD = 1.0 / (cobj[:, None] * Dd)
    stats = ChunkStats(
        pri=torch.maximum(inf((Cx - zc) / Ec), inf((Bx - zb) / Eb)),
        dua=inf((Px + q + Aty) * inv_cD),
        ax_n=torch.maximum(inf(Cx / Ec), inf(Bx / Eb)),
        z_n=torch.maximum(inf(zc / Ec), inf(zb / Eb)),
        pAty_n=torch.maximum(inf(Px * inv_cD), inf(Aty * inv_cD)))
    return (x, zc, zb, yc, yb), stats


def chunk_flops(Wb: torch.Tensor, D: int, n_iters: int) -> int:
    """Floating-point operations one chunk needs on these inputs: per
    iteration and problem the dense ``Minv`` matvec (2 n^2), the banded
    products ``C x`` and ``C' w`` (2 K*D each per row that holds a
    weight; padded rows need none) and the elementwise updates (21 per
    column, 13 per row); then the statistics (``P x``, ``C x``, ``C' y``
    and about 10 per column and row)."""
    B, T, R, KD = Wb.shape
    n = T * D
    rows = int((Wb != 0).any(-1).sum())
    per_iter = B * (2 * n * n + 21 * n) + rows * (4 * KD + 13)
    stats = B * (2 * n * n + 10 * n) + rows * (4 * KD + 10)
    return n_iters * per_iter + stats


def chunk_cuda(Minv, Wb, P, q, lc, uc, cr, rho_c, lb, ub, bd, Ec, Eb, Dd,
               cobj, x, zc, zb, yc, yb, *, D, sigma, alpha, rho_b, n_iters,
               active=None):
    """Launch the kernel on the current stream, one cluster of
    :func:`cluster_plan`'s size per problem.  ``active`` [B] bool skips
    lanes (their outputs are left unwritten; :func:`chunk` masks them)."""
    args = (Minv, Wb, P, q, lc, uc, cr, rho_c, lb, ub, bd, Ec, Eb, Dd, cobj,
            x, zc, zb, yc, yb)
    B, T, R, KD = Wb.shape
    if KD % D:
        raise ValueError(f"window width {KD} is not a multiple of D={D}")
    K, n, m = KD // D, T * D, T * R
    shapes = {"Minv": (B, n, n), "Wb": (B, T, R, KD), "P": (B, n, n),
              "cobj": (B,)}
    for name in ("q", "lb", "ub", "bd", "Eb", "Dd", "x", "zb", "yb"):
        shapes[name] = (B, n)
    for name in ("lc", "uc", "cr", "rho_c", "Ec", "zc", "yc"):
        shapes[name] = (B, m)
    dev = Wb.device
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
    cs, _ = _prepare(dev.index, T, D, K, R)
    outs = [torch.empty_like(t) for t in (x, zc, zb, yc, yb)]
    stats = torch.empty(B, 5, dtype=torch.float32, device=dev)
    act = None
    if active is not None:
        act = active.to(device=dev, dtype=torch.int32).contiguous()
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().admm_block_chunk(
            *[t.data_ptr() for t in args], *[o.data_ptr() for o in outs],
            stats.data_ptr(), None if act is None else act.data_ptr(),
            B, T, D, K, R, cs, float(sigma), float(alpha), float(rho_b),
            int(n_iters), stream)
        if err != 0:
            raise RuntimeError(f"admm_block_chunk launch failed: CUDA error "
                               f"{err}")
        profiling.count("qp.block_chunk.launches")
    return tuple(outs), ChunkStats(*stats.unbind(-1))


def chunk(*args, D, sigma, alpha, rho_b, n_iters, active=None):
    """One fused chunk (see module doc).  CPU tensors take the plain
    version; CUDA tensors launch the kernel.  With ``active`` [B] bool,
    inactive lanes return their input state unchanged."""
    dev = args[0].device
    if dev.type == "cpu":
        state, stats = chunk_plain(*args, D=D, sigma=sigma, alpha=alpha,
                                   rho_b=rho_b, n_iters=n_iters)
    elif dev.type == "cuda":
        state, stats = chunk_cuda(*args, D=D, sigma=sigma, alpha=alpha,
                                  rho_b=rho_b, n_iters=n_iters, active=active)
    else:
        raise ValueError(f"no chunk implementation for device {dev}")
    if active is None:
        return state, stats
    keep = active[:, None]
    state = tuple(torch.where(keep, new, old)
                  for new, old in zip(state, args[15:]))
    nan = float("nan")
    stats = ChunkStats(*(torch.where(active, s, torch.full_like(s, nan))
                         for s in stats))
    return state, stats
