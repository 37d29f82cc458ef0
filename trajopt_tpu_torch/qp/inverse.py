"""Explicit KKT inverses: Cholesky, and the warm-started Newton-Schulz
refresh, on batches ``[B, n, n]``.

Counterpart of ``trajopt_tpu/qp/inverse.py``.  The JAX functions run per
problem under ``vmap``, so their ``while_loop``s stop per lane; here each
loop runs while any lane is active and a lane whose condition is false
keeps its state, which reproduces the per-lane results exactly.  The work
is batched GEMM and factorization, left to ``torch.matmul`` and
``torch.linalg`` as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch

from trajopt_tpu_torch.utils.profiling import host_read


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


def _ns_loop(M, X, r, k, tol, budget):
    """X <- X (2I - M X) per lane while (r > tol) & (k < budget); r is
    the Frobenius residual of the iterate before the last update."""
    eye = _eye(M)
    active = (r > tol) & (k < budget)
    while host_read("qp", "ns", bool, active.any()):
        E = eye - M @ X
        r_new = _fro(E)
        X_new = X + X @ E
        X = torch.where(active[:, None, None], X_new, X)
        r = torch.where(active, r_new, r)
        k = k + active.to(k.dtype)
        active = (r > tol) & (k < budget)
    return X


def ns_inverse(M: torch.Tensor, X0: torch.Tensor, *, tol: float = 1e-5,
               max_iter: int = 25, power_iters: int = 8,
               target: float = 1.8, coarse: bool = False,
               coarse_tol: float = 5e-2) -> torch.Tensor:
    """Refresh SPD inverses [B, n, n] from seeds ``X0`` by safeguarded
    Newton-Schulz: seed scaled into the contraction region by a power
    iteration, residual-guarded loop, and a rescue from the guaranteed
    seed ``(target / ||M||_F) I`` for lanes left non-finite or with
    residual > 1.  ``coarse`` runs a first phase to ``coarse_tol`` at the
    same (full) precision."""
    B = M.shape[0]
    lam = _lam_max_estimate(M, X0, power_iters)
    margin = 1.1 if power_iters >= 8 else 1.2 + 0.8 / max(power_iters, 1)
    t = torch.minimum(M.new_ones(()), target / (margin * lam))
    X = t[:, None, None] * X0

    def phase(X, phase_tol, budget):
        r = M.new_full((B,), float("inf"))
        k = torch.zeros(B, dtype=torch.int32, device=M.device)
        return _ns_loop(M, X, r, k, phase_tol, budget)

    if coarse:
        X = phase(X, coarse_tol, max_iter)
    X = phase(X, tol, max_iter)

    eye = _eye(M)
    r = _fro(eye - M @ X)
    bad = ~torch.isfinite(r) | (r > 1.0)
    X_safe = (target / (_fro(M) + 1e-30))[:, None, None] * eye
    X = torch.where(bad[:, None, None], X_safe, X)
    r0 = torch.where(bad, torch.full_like(r, float("inf")),
                     torch.zeros_like(r))
    k0 = torch.zeros(B, dtype=torch.int32, device=M.device)
    return _ns_loop(M, X, r0, k0, tol, 4 * max_iter)
