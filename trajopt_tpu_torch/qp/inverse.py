"""Explicit KKT inverses: Cholesky, and the warm-started Newton-Schulz
refresh, on batches ``[B, n, n]``.

Counterpart of ``trajopt_tpu/qp/inverse.py``.  The JAX functions run per
problem under ``vmap``, so their ``while_loop``s stop per lane; here each
lane carries its own stop test, and a lane whose test failed keeps its
state, which reproduces the per-lane results exactly.  Cholesky is left to
``torch.linalg`` as the JAX package leaves it to XLA.

The refresh's loop runs as two hand-written kernels an iteration
(``csrc/ns_refresh.cu``: ``ns_residual``, ``E = I - M X`` from M's block
band with the norm and the stop test, and ``ns_update``, ``X <- X + X E``)
on a CUDA tensor, and as their plain PyTorch version (:class:`_Plain`) on
a CPU tensor; a CUDA tensor launches the kernels or raises.  On the card a
phase's ``max_iter`` iterations are launched back to back (a stopped lane
leaves both kernels at once) and one host read per refresh brings the
rescue test's count and the lanes' iterations; the CPU keeps a read each
iteration, which costs nothing there.  The kernel is built with ``nvcc``
for ``sm_90a`` at first use into ``trajopt_tpu_torch/_build/`` and bound
with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from trajopt_tpu_torch import kernels
from trajopt_tpu_torch.utils.profiling import count, host_read

SOURCE = kernels.CSRC / "ns_refresh.cu"
_LIB = None
START, STEP, FINAL = 0, 1, 2          # ns_residual's modes
S_K, S_KT, S_ACT, S_UPD = range(4)    # fields of the card's per-lane state


def build(verbose: bool = False):
    """Compile the kernels (once per source hash) and return the library
    path; see ``kernels.build_library``."""
    return kernels.build_library(SOURCE, verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ns_residual.argtypes = [ci] + [vp] * 7 + [ci] * 4 \
            + [ctypes.c_double] + [ci] * 3 + [vp]
        lib.ns_residual.restype = ci
        lib.ns_update.argtypes = [ci] + [vp] * 4 + [ci] * 3 + [vp]
        lib.ns_update.restype = ci
        _LIB = lib
    return _LIB


def _eye(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def cholesky_inverse(M: torch.Tensor) -> torch.Tensor:
    """Explicit SPD inverse via Cholesky + two triangular solves.  A lane
    whose M is not positive definite gets NaN (as JAX's Cholesky gives),
    which the solver's QP-failure guard then catches."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[:, None, None], L,
                    torch.full_like(L, float("nan")))
    eye = _eye(M).expand_as(M)
    w = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)


def _fro(E: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(E)


def _lam_max_estimate(M, X0, iters: int) -> torch.Tensor:
    """Power-iteration estimate of lam_max(X0 M) per lane [B]."""
    n = M.shape[-1]
    v = torch.cos(torch.arange(n, dtype=M.dtype, device=M.device) * 0.7) + 0.01
    v = (v / torch.linalg.vector_norm(v)).expand(M.shape[0], n)
    lam = M.new_ones(M.shape[0])
    for _ in range(iters):
        w = (X0 @ (M @ v[..., None]))[..., 0]
        nw = torch.linalg.vector_norm(w, dim=-1)
        lam = nw
        v = w / (nw + 1e-30)[:, None]
    return lam


def band_mm(M: torch.Tensor, X: torch.Tensor, band) -> torch.Tensor:
    """``M @ X`` [B, n, n] reading only M's block band: ``band = (D, hb)``
    says that rows of step I (D rows a step) are zero beyond the columns of
    steps I - hb .. I + hb; ``None``, or a band that covers every step, is
    the dense product."""
    B, n, _ = M.shape
    if band is None or n % band[0] or band[1] >= n // band[0] - 1:
        return M @ X
    D, hb = band
    T = n // D
    Mb = M.reshape(B, T, D, T, D)
    Xb = X.reshape(B, T, D, n)
    out = torch.zeros_like(Xb)
    for o in range(-hb, hb + 1):
        # the blocks M[I, I + o] as [B, T - |o|, D, D]
        blk = torch.diagonal(Mb, offset=o, dim1=1, dim2=3).permute(0, 3, 1, 2)
        if o >= 0:
            out[:, :T - o] += blk @ Xb[:, o:]
        else:
            out[:, -o:] += blk @ Xb[:, :T + o]
    return out.reshape(B, n, n)


class _Plain:
    """The refresh's state and the kernels' arithmetic in PyTorch: the
    iterate X and per lane r, k (the phase's iterations), kt (the
    refresh's), the stop test's verdict and whether this iteration's
    residual ran (see ``csrc/ns_refresh.cu``)."""

    def __init__(self, M: torch.Tensor, X0: torch.Tensor, t: torch.Tensor,
                 band):
        B = M.shape[0]
        self.M, self.X, self.band = M, t[:, None, None] * X0, band
        self.eye = _eye(M)
        self.r = M.new_zeros(B)
        self.k = torch.zeros(B, dtype=torch.int32, device=M.device)
        self.kt = torch.zeros_like(self.k)
        self.active = torch.zeros(B, dtype=torch.bool, device=M.device)
        self.upd = torch.zeros_like(self.active)
        self.E = None

    def residual(self, tol: float, budget: int, mode: int):
        if mode == START:
            self.k = torch.zeros_like(self.k)
            self.active = torch.full_like(self.active,
                                          budget > 0 and tol < float("inf"))
        E = self.eye - band_mm(self.M, self.X, self.band)
        r = torch.sqrt((E * E).sum((-2, -1)))
        if mode == FINAL:
            self.r = r
            self.active = ~torch.isfinite(r) | (r > 1.0)
            self.k = torch.zeros_like(self.k)
            self.upd = torch.zeros_like(self.upd)
            return
        go = self.active
        self.E = E
        self.r = torch.where(go, r, self.r)
        self.k = self.k + go.to(self.k.dtype)
        self.kt = self.kt + go.to(self.kt.dtype)
        self.active = (self.r > tol) & (self.k < budget)
        self.upd = go

    def update(self):
        X_new = self.X + self.X @ self.E
        self.X = torch.where(self.upd[:, None, None], X_new, self.X)

    def tally(self) -> torch.Tensor:
        """[the lanes' summed kt, lanes whose test holds] (int)."""
        return torch.stack([self.kt.sum(), self.active.sum()])

    def any_active(self) -> torch.Tensor:
        return self.active.any()

    def restart(self, X: torch.Tensor):
        """The rescue: iterate ``X``, kt = 0; the lanes that failed the
        rescue test stay active."""
        self.X = X
        self.kt = torch.zeros_like(self.kt)

    def bad(self) -> torch.Tensor:
        return self.active

    def result(self) -> torch.Tensor:
        return self.X


class _Card:
    """The same state on the card for ``csrc/ns_refresh.cu``: two buffers
    for the iterate (kt's parity says which holds a lane's), E, r and the
    per-lane ints st [B, 4] = (k, kt, active, upd)."""

    def __init__(self, M: torch.Tensor, X0: torch.Tensor, t: torch.Tensor,
                 band):
        if M.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"ns_refresh: expected float32 or float64, got "
                            f"{M.dtype}")
        if M.dim() != 3 or M.shape[1] != M.shape[2]:
            raise ValueError(f"ns_refresh: expected M [B, n, n], got "
                             f"{tuple(M.shape)}")
        if X0.shape != M.shape or X0.dtype != M.dtype \
                or X0.device != M.device:
            raise ValueError("ns_refresh: the seed must match M in shape, "
                             "dtype and device")
        B, n = M.shape[0], M.shape[-1]
        if B > 65535:
            raise ValueError(f"ns_refresh: at most 65535 lanes, got {B}")
        self.M = M.contiguous()
        self.X = M.new_empty((2, B, n, n))
        torch.mul(X0, t[:, None, None], out=self.X[0])
        self.E = torch.empty_like(self.M)
        self.out = torch.empty_like(self.M)
        self.r = M.new_empty(B)
        self.st = torch.zeros(B, 4, dtype=torch.int32, device=M.device)
        self.D, self.hb = (n, 0) if band is None else (band[0], min(band[1],
                                                                    n))
        self.dtype = 0 if M.dtype == torch.float32 else 1
        ptrs = [t.data_ptr() for t in (self.M, self.X[0], self.X[1], self.E,
                                       self.out)]
        self.vec = int(n % (4 if self.dtype == 0 else 2) == 0
                       and all(p % 16 == 0 for p in ptrs))
        self.stream = torch.cuda.current_stream(M.device).cuda_stream
        self.rescued = False

    def _check(self, err: int, name: str):
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        count("qp.ns.launches")

    def residual(self, tol: float, budget: int, mode: int):
        B, n = self.M.shape[0], self.M.shape[-1]
        self._check(_lib().ns_residual(
            self.dtype, self.M.data_ptr(), self.X[0].data_ptr(),
            self.X[1].data_ptr(), self.E.data_ptr(), self.out.data_ptr(),
            self.r.data_ptr(), self.st.data_ptr(), B, n, self.D, self.hb,
            float(tol), int(budget), mode, self.vec, self.stream),
            "ns_residual")

    def update(self):
        B, n = self.M.shape[0], self.M.shape[-1]
        self._check(_lib().ns_update(
            self.dtype, self.X[0].data_ptr(), self.X[1].data_ptr(),
            self.E.data_ptr(), self.st.data_ptr(), B, n, self.vec,
            self.stream), "ns_update")

    def tally(self) -> torch.Tensor:
        return self.st[:, S_KT:S_ACT + 1].sum(0)

    def any_active(self) -> torch.Tensor:
        return self.st[:, S_ACT].any()

    def restart(self, X: torch.Tensor):
        self.X[0].copy_(X)
        self.st[:, S_KT] = 0
        self.rescued = True

    def bad(self) -> torch.Tensor:
        return self.st[:, S_ACT].bool()

    def result(self) -> torch.Tensor:
        if not self.rescued:
            return self.out
        odd = (self.st[:, S_KT] & 1).bool()[:, None, None]
        return torch.where(odd, self.X[1], self.X[0])


def _ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in t.tolist()]


def _iterate(dev, tol: float, budget: int, n: int, first: int,
             reads: bool) -> int:
    """``n`` iterations (residual, update) under the stop test ``(r >
    tol) & (k < budget)``, the first in mode ``first``; with ``reads``
    (the CPU) they end early once no lane is active.  Returns how many
    ran."""
    for it in range(n):
        if reads and it and not host_read("qp", "ns", bool,
                                          dev.any_active()):
            return it
        dev.residual(tol, budget, first if it == 0 else STEP)
        dev.update()
    return n


def _refresh(state, M, X0, *, tol, max_iter, power_iters, target, coarse,
             coarse_tol, band, reads):
    """The refresh on ``state`` (:class:`_Card` or :class:`_Plain`, made
    from M, the seed, its scale and the band); see :func:`ns_inverse`."""
    B = M.shape[0]
    lam = _lam_max_estimate(M, X0, power_iters)
    margin = 1.1 if power_iters >= 8 else 1.2 + 0.8 / max(power_iters, 1)
    t = torch.minimum(M.new_ones(()), target / (margin * lam))
    dev = state(M, X0, t, band)
    ran = 0
    for phase_tol in ([coarse_tol] if coarse else []) + [tol]:
        ran += _iterate(dev, phase_tol, max_iter, max_iter, START, reads)
    dev.residual(tol, 0, FINAL)
    iters, n_bad = host_read("qp", "ns", _ints, dev.tally())
    if n_bad:
        bad = dev.bad()[:, None, None]
        X_safe = (target / (_fro(M) + 1e-30))[:, None, None] * _eye(M)
        dev.restart(torch.where(bad, X_safe, dev.result()))
        for _ in range(4):
            ran += _iterate(dev, tol, 4 * max_iter, max_iter, STEP, reads)
            rescue_iters, n_act = host_read("qp", "ns", _ints, dev.tally())
            if not n_act:
                break
        iters += rescue_iters
    count("qp.ns.lane_refreshes", B)
    count("qp.ns.lane_slots", B * ran)
    count("qp.ns.lane_iters", iters)
    return dev.result()


def ns_inverse_plain(M: torch.Tensor, X0: torch.Tensor, *, tol: float = 1e-5,
                     max_iter: int = 25, power_iters: int = 8,
                     target: float = 1.8, coarse: bool = False,
                     coarse_tol: float = 5e-2, band=None) -> torch.Tensor:
    """:func:`ns_inverse`'s plain PyTorch version, on any device: a phase
    ends at the first iteration with no active lane (a host read each
    iteration)."""
    return _refresh(_Plain, M, X0, tol=tol, max_iter=max_iter,
                    power_iters=power_iters, target=target, coarse=coarse,
                    coarse_tol=coarse_tol, band=band, reads=True)


def ns_inverse(M: torch.Tensor, X0: torch.Tensor, *, tol: float = 1e-5,
               max_iter: int = 25, power_iters: int = 8,
               target: float = 1.8, coarse: bool = False,
               coarse_tol: float = 5e-2, band=None) -> torch.Tensor:
    """Refresh SPD inverses [B, n, n] from seeds ``X0`` by safeguarded
    Newton-Schulz: seed scaled into the contraction region by a power
    iteration, residual-guarded loop, and a rescue from the guaranteed
    seed ``(target / ||M||_F) I`` for lanes left non-finite or with
    residual > 1.  ``coarse`` runs a first phase to ``coarse_tol`` at the
    same (full) precision.  ``band = (D, hb)``: M is zero beyond hb steps
    of D columns from a row's own step (:func:`band_mm`); None: dense.

    A CUDA tensor runs the kernels of ``csrc/ns_refresh.cu``, each phase's
    ``max_iter`` iterations launched with no host read; a CPU tensor their
    plain version, each phase ending at the first iteration with no active
    lane (:func:`ns_inverse_plain`).  Either way each lane stops on its
    own test."""
    if M.device.type == "cuda":
        return _refresh(_Card, M, X0, tol=tol, max_iter=max_iter,
                        power_iters=power_iters, target=target,
                        coarse=coarse, coarse_tol=coarse_tol, band=band,
                        reads=False)
    if M.device.type == "cpu":
        return ns_inverse_plain(M, X0, tol=tol, max_iter=max_iter,
                                power_iters=power_iters, target=target,
                                coarse=coarse, coarse_tol=coarse_tol,
                                band=band)
    raise ValueError(f"no Newton-Schulz refresh for device {M.device}")
