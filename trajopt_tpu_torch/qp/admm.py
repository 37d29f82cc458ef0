"""Prox-ADMM QP solver (OSQP-style splitting) on batches of dense QPs,
and the configuration, result container and dual-magnitude cost rescale
shared with the block path.

Counterpart of ``trajopt_tpu/qp/admm.py``: minimize ``0.5 x'Px + q'x +
sum_i c_i dist((Ax)_i, [l_i, u_i])`` (``c_i = inf``: a hard row) by

    xt = (P + sigma I + A'RA)^-1 (sigma x - q + A'(R z - y))
    x+ = alpha xt + (1 - alpha) x,  zr = alpha A xt + (1 - alpha) z
    z+ = prox_{c dist / rho}(zr + y / rho),  y+ = y + R (zr - z+)

on a Ruiz-equilibrated problem, with termination on the unscaled OSQP
residuals every ``check_every`` iterations, optional adaptive rho (with
refactorization) and safeguarded Anderson acceleration.  The JAX function
solves one problem and is batched by ``vmap`` over its ``while_loop``;
here the batch is the leading axis and the chunk loop runs while any lane
is live, a finished lane keeping its state.  Each chunk of iterations is
one ``fused_dense.chunk``: its CUDA kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from trajopt_tpu_torch.qp import fused_dense
from trajopt_tpu_torch.qp.inverse import cholesky_inverse
from trajopt_tpu_torch.utils.profiling import count, host_read, span


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Solver configuration (OSQP-like defaults).

    ``use_pallas`` and ``pallas_sub_batch`` are accepted so a JAX
    ``ADMMConfig`` converts field for field, and are ignored: on a CUDA
    tensor both QP paths always run their hand-written chunk kernel
    (qp/fused_block.py, qp/fused_dense.py), and the sub-batch is a TPU
    VMEM knob.  ``adaptive_rho`` and ``anderson`` act on the dense path
    only; the block path uses fixed rho, as the JAX block path does.
    ``ns_*`` act on the block path only.  ``ns_coarse`` runs its coarse
    Newton-Schulz phase at full precision (the port keeps TF32 off
    everywhere).
    """

    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    max_iter: int = 500
    check_every: int = 25
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    adaptive_rho: bool = True
    adaptive_rho_threshold: float = 5.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    # Global rho boost from the largest finite scaled penalty weight (the
    # fix for dual starvation of escalated-penalty QPs), folded into the
    # cost normalization by apply_dual_cost_scale.
    rho_dual_scale: float = 0.0
    rho_dual_thresh: float = 100.0
    ruiz_iters: int = 10
    use_pallas: bool = False
    pallas_sub_batch: int = 32
    ns_refresh: bool = False
    ns_tol: float = 1e-5
    ns_max_iter: int = 25
    ns_power_iters: int = 8
    ns_coarse: bool = False
    anderson: int = 0


class ADMMResult(NamedTuple):
    x: torch.Tensor          # [B, n]
    z: torch.Tensor          # [B, m]
    y: torch.Tensor          # [B, m]
    iters: torch.Tensor      # [B] int
    pri_res: torch.Tensor    # [B]
    dua_res: torch.Tensor    # [B]
    converged: torch.Tensor  # [B] bool


def _prox_dist(v, l, u, c_over_rho):
    """Prox of c * dist(., [l, u]) with step 1/rho, elementwise; for
    c = +inf it is clip(v, l, u)."""
    return torch.where(v > u, torch.maximum(u, v - c_over_rho),
                       torch.where(v < l, torch.minimum(l, v + c_over_rho),
                                   v))


def _dual_rho_scale(c: torch.Tensor, cfg: ADMMConfig) -> torch.Tensor:
    """Per-lane factor gamma >= 1 from the largest finite (scaled) penalty
    weight of c [B, m] — see ADMMConfig.rho_dual_scale."""
    one = c.new_ones(c.shape[0])
    if cfg.rho_dual_scale <= 0.0:
        return one
    max_c = torch.amax(torch.where(torch.isinf(c), torch.zeros_like(c), c), -1)
    gs = torch.maximum(one, cfg.rho_dual_scale * max_c)
    return torch.where(max_c >= cfg.rho_dual_thresh, gs, one)


def apply_dual_cost_scale(P, q, c, c_obj, cfg: ADMMConfig):
    """Scale the objective (P, q, penalty weights c) down by gamma, which is
    exactly equivalent to boosting every rho by gamma.  Shapes: P [B,n,n],
    q [B,n], c [B,m], c_obj [B].  Returns (P, q, c, c_obj) scaled."""
    gamma = _dual_rho_scale(c, cfg)
    c = torch.where(torch.isinf(c), c, c / gamma[:, None])
    return (P / gamma[:, None, None], q / gamma[:, None], c, c_obj / gamma)


# ----------------------------------------------------------------------
# The dense solver.

class QPData(NamedTuple):
    """Batched QPs in prox form: P [B,n,n] PSD, q [B,n], A [B,m,n] (z = Ax),
    l, u [B,m] interval bounds on z, c [B,m] penalty weights (inf: hard)."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    c: torch.Tensor


class Scaling(NamedTuple):
    """Ruiz scalings: x = D x_scaled, z rows scaled by E, the objective by
    c_obj."""

    D: torch.Tensor      # [B, n]
    E: torch.Tensor      # [B, m]
    c_obj: torch.Tensor  # [B]


def _inv_sqrt(v):
    return torch.where(v < 1e-12, torch.ones_like(v), 1.0 / torch.sqrt(v))


def _inf_norm(v):
    """Per-lane inf-norm over the last axis (NaN propagates)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(torch.abs(v), -1)


def ruiz_equilibrate(qp: QPData, iters: int = 10) -> tuple[QPData, Scaling]:
    """OSQP's modified Ruiz equilibration of [P A'; A 0] plus cost scaling;
    penalty weights transform as c_obj * c / E (hard rows stay inf)."""
    P, q, A = qp.P, qp.q, qp.A
    B, m, n = A.shape
    D, E, c_obj = q.new_ones(B, n), q.new_ones(B, m), q.new_ones(B)
    for _ in range(iters):
        col = torch.maximum(torch.amax(torch.abs(P), -2),
                            torch.amax(torch.abs(A), -2))
        d = _inv_sqrt(col)
        P = d[:, :, None] * P * d[:, None, :]
        q = d * q
        A = A * d[:, None, :]
        e = _inv_sqrt(torch.amax(torch.abs(A), -1))
        A = e[:, :, None] * A
        g_den = torch.maximum(torch.mean(torch.amax(torch.abs(P), -2), -1),
                              torch.amax(torch.abs(q), -1))
        g = torch.where(g_den < 1e-12, torch.ones_like(g_den), 1.0 / g_den)
        P, q = g[:, None, None] * P, g[:, None] * q
        D, E, c_obj = D * d, E * e, c_obj * g
    c = torch.where(torch.isinf(qp.c), qp.c, c_obj[:, None] * qp.c / E)
    return (QPData(P, q, A, qp.l * E, qp.u * E, c),
            Scaling(D=D, E=E, c_obj=c_obj))


def _row_rho(qp: QPData, cfg: ADMMConfig, rho_scale) -> torch.Tensor:
    """Per-row rho [B, m]: base rho, boosted on hard equality rows (OSQP's
    heuristic), times the lane's ``rho_scale`` [B]."""
    hard_eq = torch.isinf(qp.c) & ((qp.u - qp.l) < 1e-10)
    base = torch.where(hard_eq, torch.full_like(qp.c, cfg.rho
                                                * cfg.rho_eq_scale),
                       torch.full_like(qp.c, cfg.rho))
    return torch.clamp(base * rho_scale[:, None], cfg.rho_min, cfg.rho_max)


def _factor(qp: QPData, cfg: ADMMConfig, rho_vec) -> torch.Tensor:
    """Explicit inverse [B, n, n] of M = P + sigma I + A'RA (Cholesky and
    two triangular solves, as the JAX version)."""
    n = qp.P.shape[-1]
    M = qp.P + cfg.sigma * torch.eye(n, dtype=qp.P.dtype,
                                     device=qp.P.device) \
        + qp.A.transpose(-1, -2) @ (rho_vec[..., None] * qp.A)
    return cholesky_inverse(M)


class _DenseState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    rho_scale: torch.Tensor
    iters: torch.Tensor
    pri: torch.Tensor
    dua: torch.Tensor
    converged: torch.Tensor
    aa_V: torch.Tensor      # [B, K, 2m] Anderson history of v_end
    aa_F: torch.Tensor      # [B, K, 2m] residuals v_end - v_start
    aa_cnt: torch.Tensor


def _anderson(st: _DenseState, z, y, v_start, pri, converged, rho_vec,
              K: int):
    """Type-II Anderson step on v = (z, y / rho) at chunk granularity,
    safeguarded by primal-residual progress.  Returns (z, y, aa_V, aa_F,
    aa_cnt)."""
    m = z.shape[-1]
    v_end = torch.cat([z, y / rho_vec], -1)
    diverged = pri > st.pri
    aa_cnt = torch.where(diverged, torch.zeros_like(st.aa_cnt), st.aa_cnt)
    aa_V = torch.cat([v_end[:, None], st.aa_V[:, :-1]], 1)
    aa_F = torch.cat([(v_end - v_start)[:, None], st.aa_F[:, :-1]], 1)
    aa_cnt = aa_cnt + 1
    valid = torch.arange(K, device=z.device) < torch.clamp_max(
        aa_cnt, K)[:, None]                                     # [B, K]
    eye = torch.eye(K, dtype=z.dtype, device=z.device)
    G = aa_F @ aa_F.transpose(-1, -2)
    G = torch.where(valid[:, :, None] & valid[:, None, :], G, eye)
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    G = G + 1e-10 * tr[:, None, None] * eye
    ones = valid.to(z.dtype)
    sol = torch.linalg.solve_ex(G, ones)[0]
    alpha = sol / torch.maximum((sol * ones).sum(-1, keepdim=True),
                                sol.new_tensor(1e-12))
    v_aa = ((alpha * ones)[:, :, None] * aa_V).sum(1)
    use = (aa_cnt >= 2) & ~diverged & ~converged \
        & torch.isfinite(v_aa).all(-1)
    z = torch.where(use[:, None], v_aa[:, :m], z)
    y = torch.where(use[:, None], v_aa[:, m:] * rho_vec, y)
    return z, y, aa_V, aa_F, aa_cnt


def scale_qp(qp: QPData, cfg: ADMMConfig) -> tuple[QPData, Scaling]:
    """The problem the iterations run on: Ruiz-equilibrated, then the
    objective scaled down by the dual-magnitude factor."""
    qp, sc = ruiz_equilibrate(qp, cfg.ruiz_iters)
    P2, q2, c2, c_obj2 = apply_dual_cost_scale(qp.P, qp.q, qp.c, sc.c_obj,
                                               cfg)
    return qp._replace(P=P2, q=q2, c=c2), sc._replace(c_obj=c_obj2)


def chunk_operands(qp: QPData, x0, cfg: ADMMConfig = ADMMConfig()):
    """The operands of ``fused_dense.chunk`` for the first chunk of a cold
    start (rho unscaled, z = A x0, y = 0), in its argument order."""
    sq, sc = scale_qp(qp, cfg)
    rho = _row_rho(sq, cfg, x0.new_ones(x0.shape[0]))
    x = x0.to(sq.A.dtype) / sc.D
    return tuple(t.contiguous() for t in (
        _factor(sq, cfg, rho), sq.A, sq.q, sq.l, sq.u, sq.c / rho, rho, x,
        (sq.A @ x[..., None])[..., 0], torch.zeros_like(sq.l)))


class DensePrepared(NamedTuple):
    """What the chunk loop of :func:`solve_qp_prepared` starts from: the
    scaled QP, its scaling, the scaled warm start and the termination
    constants; ``rho`` and ``minv`` are the rows' rho and the
    factorization under fixed rho (None with ``adaptive_rho``, which
    refactors before every chunk)."""

    qp: QPData
    sc: Scaling
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    q_norm: torch.Tensor
    rho: torch.Tensor | None
    minv: torch.Tensor | None


def prepare_qp(qp: QPData, x0, z0=None, y0=None,
               cfg: ADMMConfig = ADMMConfig()) -> DensePrepared:
    """Everything of :func:`solve_qp` before its chunk loop: equilibrate,
    scale the warm start (x0, z0, y0, unscaled units) and, under fixed
    rho, factor once.  Syncs nothing with the host."""
    orig_q = qp.q
    qp, sc = scale_qp(qp, cfg)
    qp = qp._replace(A=qp.A.contiguous())
    A = qp.A
    B, m = A.shape[:2]
    x = x0.to(A.dtype) / sc.D
    z = (A @ x[..., None])[..., 0] if z0 is None else z0.to(A.dtype) * sc.E
    y = (x.new_zeros(B, m) if y0 is None
         else y0.to(A.dtype) * (sc.c_obj[:, None] / sc.E))
    rho = minv = None
    if not cfg.adaptive_rho:
        # rho never changes: factor once, outside the chunk loop.
        rho = _row_rho(qp, cfg, x.new_ones(B))
        minv = _factor(qp, cfg, rho)
    return DensePrepared(qp=qp, sc=sc, x=x, z=z, y=y,
                         q_norm=_inf_norm(orig_q), rho=rho, minv=minv)


def solve_qp(qp: QPData, x0, z0=None, y0=None,
             cfg: ADMMConfig = ADMMConfig()) -> ADMMResult:
    """Solve a batch of QPs, warm-started from (x0, z0, y0) in unscaled
    units; termination residuals are unscaled (OSQP).  A lane runs chunks
    of ``check_every`` iterations while it is not converged and under
    ``max_iter``."""
    with span("qp.prepare"):
        prep = prepare_qp(qp, x0, z0, y0, cfg)
    return solve_qp_prepared(prep, cfg)


def solve_qp_prepared(prep: DensePrepared,
                      cfg: ADMMConfig = ADMMConfig()) -> ADMMResult:
    """The chunk loop of :func:`solve_qp` on a prepared QP."""
    qp, sc, x, z, y, q_norm = prep[:6]
    A, P = qp.A, qp.P
    B, m = A.shape[:2]
    dev = A.device
    cD = sc.c_obj[:, None] * sc.D

    K = max(cfg.anderson, 1)
    inf = float("inf")
    st = _DenseState(
        x=x, z=z, y=y, rho_scale=x.new_ones(B),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        pri=x.new_full((B,), inf), dua=x.new_full((B,), inf),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
        aa_V=x.new_zeros(B, K, 2 * m), aa_F=x.new_zeros(B, K, 2 * m),
        aa_cnt=torch.zeros(B, dtype=torch.int32, device=dev))
    run = st.iters < cfg.max_iter               # no lane has converged yet
    # The live lanes as int32 step ``iters``, and their sum is the loop's one
    # host read a chunk (a sum of the bool mask would cast it first).
    on = run.to(torch.int32)
    n_run = host_read("qp", "dense_chunk", int, on.sum(dtype=on.dtype))
    count("qp.admm.lane_solves", n_run)
    while n_run:
        count("qp.admm.lane_iters", n_run * cfg.check_every)
        if cfg.adaptive_rho:
            rho_vec = _row_rho(qp, cfg, st.rho_scale)
            with span("qp.prepare"):
                minv = _factor(qp, cfg, rho_vec)
        else:
            rho_vec, minv = prep.rho, prep.minv
        v_start = torch.cat([st.z, st.y / rho_vec], -1)
        x, z, y, Ax = fused_dense.chunk(
            minv.contiguous(), A, qp.q.contiguous(), qp.l.contiguous(),
            qp.u.contiguous(), (qp.c / rho_vec).contiguous(),
            rho_vec.contiguous(), st.x.contiguous(), st.z.contiguous(),
            st.y.contiguous(), sigma=cfg.sigma, alpha=cfg.alpha,
            n_iters=cfg.check_every, active=run)

        # Unscaled residuals (OSQP computes termination in original units).
        Px = (P @ x[..., None])[..., 0]
        Aty = (A.transpose(-1, -2) @ y[..., None])[..., 0]
        Ax_un, z_un = Ax / sc.E, z / sc.E
        pri = _inf_norm(Ax_un - z_un)
        dua = _inf_norm((Px + qp.q + Aty) / cD)
        eps_pri = cfg.eps_abs + cfg.eps_rel * torch.maximum(
            _inf_norm(Ax_un), _inf_norm(z_un))
        eps_dua = cfg.eps_abs + cfg.eps_rel * torch.maximum(
            torch.maximum(_inf_norm(Px / cD), _inf_norm(Aty / cD)),
            q_norm)
        converged = (pri <= eps_pri) & (dua <= eps_dua)

        rho_scale = st.rho_scale
        if cfg.adaptive_rho:
            tiny = 1e-30
            ratio = torch.sqrt(
                (pri / torch.clamp_min(eps_pri, tiny))
                / torch.clamp_min(dua / torch.clamp_min(eps_dua, tiny),
                                  tiny))
            ratio = torch.clamp(torch.nan_to_num(ratio, nan=1.0), 1e-2, 1e2)
            adapt = (ratio > cfg.adaptive_rho_threshold) | \
                (ratio < 1.0 / cfg.adaptive_rho_threshold)
            rho_scale = torch.where(adapt & ~converged, rho_scale * ratio,
                                    rho_scale)
        aa_V, aa_F, aa_cnt = st.aa_V, st.aa_F, st.aa_cnt
        if cfg.anderson > 0:
            z, y, aa_V, aa_F, aa_cnt = _anderson(
                st, z, y, v_start, pri, converged, rho_vec, cfg.anderson)

        new = _DenseState(
            x=x, z=z, y=y, rho_scale=rho_scale,
            iters=torch.add(st.iters, on, alpha=cfg.check_every), pri=pri,
            dua=dua, converged=converged, aa_V=aa_V, aa_F=aa_F,
            aa_cnt=aa_cnt)
        st = _DenseState(*(
            a if f == "iters" else      # stepped on the live lanes only
            torch.where(run.view(-1, *([1] * (a.dim() - 1))), a, b)
            for f, a, b in zip(_DenseState._fields, new, st)))
        run = ~st.converged & (st.iters < cfg.max_iter)
        on = run.to(torch.int32)
        n_run = host_read("qp", "dense_chunk", int, on.sum(dtype=on.dtype))
    return ADMMResult(
        x=st.x * sc.D, z=st.z / sc.E,
        y=st.y * (sc.E / sc.c_obj[:, None]), iters=st.iters,
        pri_res=st.pri, dua_res=st.dua, converged=st.converged)



def qp_objective(qp: QPData, x: torch.Tensor) -> torch.Tensor:
    """[B] full prox-form objective 0.5 x'Px + q'x + sum_i c_i dist(A_i x,
    [l_i, u_i]) of a batch (hard rows, c = inf, contribute nothing)."""
    z = (qp.A @ x[..., None])[..., 0]
    zero = z.new_zeros(())
    viol = torch.maximum(z - qp.u, zero) + torch.maximum(qp.l - z, zero)
    soft = torch.where(torch.isinf(qp.c), torch.zeros_like(viol),
                       qp.c * viol)
    return 0.5 * (x * (qp.P @ x[..., None])[..., 0]).sum(-1) \
        + (qp.q * x).sum(-1) + soft.sum(-1)
