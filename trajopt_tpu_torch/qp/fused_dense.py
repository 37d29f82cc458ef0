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
kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``trajopt_tpu_torch/_build/`` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes

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
        lib.admm_dense_chunk.argtypes = [vp] * 15 + [ci] * 3 + [cf] * 2 \
            + [ci, vp]
        lib.admm_dense_chunk.restype = ci
        lib.admm_dense_chunk_smem.argtypes = [ci] * 2
        lib.admm_dense_chunk_smem.restype = ctypes.c_size_t
        lib.admm_dense_chunk_max_n.argtypes = []
        lib.admm_dense_chunk_max_n.restype = ci
        _LIB = lib
    return _LIB


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
    """Bytes this kernel's design streams from device memory: ``A`` once
    per iteration and once before the first, ``Minv`` once per iteration
    (neither fits in a block's shared memory at the arm7 shapes)."""
    B, m, n = A.shape
    return 4 * B * ((n_iters + 1) * m * n + n_iters * n * n)


def chunk_cuda(Minv, A, q, l, u, cr, rho, x, z, y, *, sigma, alpha, n_iters,
               active=None):
    """Launch the kernel on the current stream.  ``active`` [B] bool skips
    lanes (their outputs are left unwritten; :func:`chunk` masks them)."""
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
    lib = _lib()
    if not 0 < n <= lib.admm_dense_chunk_max_n():
        raise ValueError(f"n={n} outside the kernel's column range "
                         f"(1..{lib.admm_dense_chunk_max_n()})")
    smem = lib.admm_dense_chunk_smem(n, m)
    if smem > kernels.SMEM_LIMIT:
        raise ValueError(f"shape needs {smem} B of shared memory "
                         f"(> {kernels.SMEM_LIMIT})")
    outs = [torch.empty_like(t) for t in (x, z, y, z)]
    act = None
    if active is not None:
        act = active.to(device=dev, dtype=torch.int32).contiguous()
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.admm_dense_chunk(
            *[t.data_ptr() for t in args], *[o.data_ptr() for o in outs],
            None if act is None else act.data_ptr(), B, m, n, float(sigma),
            float(alpha), int(n_iters), stream)
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
