"""Block-banded prox-ADMM: equilibration, factorization and the solve of
the structured QP, on batches.

Counterpart of ``trajopt_tpu/qp/admm_block.py``.  The constraint block is
``block_banded.BlockBanded``; row vectors (l, u, c) and warm starts are in
block order ``[B, T*R]``, with padded slots inert (W = 0, l = -inf,
u = +inf, c = 0).  The iterations always go through the fused chunk of
``qp/fused_block.py``: its CUDA kernel on a CUDA tensor, its plain PyTorch
version on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp import fused_block
from trajopt_tpu_torch.qp.admm import ADMMConfig, ADMMResult, \
    apply_dual_cost_scale
from trajopt_tpu_torch.qp.inverse import cholesky_inverse, ns_inverse
from trajopt_tpu_torch.utils.profiling import count, host_read


class BlockQP(NamedTuple):
    """min 0.5 x'Px + q'x + sum_i c_i dist((Cx)_i, [l,u]) + box(x in [lb,ub])
    per lane; l, u, c in block row order."""

    P: torch.Tensor
    q: torch.Tensor
    C: bb.BlockBanded
    l: torch.Tensor
    u: torch.Tensor
    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor


class _Scale(NamedTuple):
    D: torch.Tensor      # [B, n]
    E_c: torch.Tensor    # [B, m]
    E_b: torch.Tensor    # [B, n]
    c_obj: torch.Tensor  # [B]


def _inv_sqrt(v):
    return torch.where(v < 1e-12, torch.ones_like(v), 1.0 / torch.sqrt(v))


def _inf(v):
    """Per-lane inf-norm over the last axis (NaN propagates)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(torch.abs(v), -1)


def _ruiz(qp: BlockQP, iters: int):
    """Ruiz equilibration of [C; I] (OSQP's modified Ruiz + cost scaling)."""
    P, q, C = qp.P, qp.q, qp.C
    B, n = q.shape
    m = C.plan.m_blk
    b_diag = q.new_ones(B, n)
    D = q.new_ones(B, n)
    E_c = q.new_ones(B, m)
    E_b = q.new_ones(B, n)
    c_obj = q.new_ones(B)
    for _ in range(iters):
        col = torch.maximum(torch.amax(torch.abs(P), -2),
                            torch.maximum(bb.col_inf_norms(C),
                                          torch.abs(b_diag)))
        d = _inv_sqrt(col)
        P = d[:, :, None] * P * d[:, None, :]
        q = d * q
        C = bb.scale_cols(C, d)
        b_diag = b_diag * d
        e_c = _inv_sqrt(bb.row_inf_norms(C))
        C = bb.scale_rows(C, e_c)
        e_b = _inv_sqrt(torch.abs(b_diag))
        b_diag = b_diag * e_b
        g_den = torch.maximum(torch.mean(torch.amax(torch.abs(P), -2), -1),
                              torch.amax(torch.abs(q), -1))
        g = torch.where(g_den < 1e-12, torch.ones_like(g_den), 1.0 / g_den)
        P, q = g[:, None, None] * P, g[:, None] * q
        c_obj = c_obj * g
        D, E_c, E_b = D * d, E_c * e_c, E_b * e_b
    scaled = BlockQP(
        P=P, q=q, C=C, l=qp.l * E_c, u=qp.u * E_c,
        c=torch.where(torch.isinf(qp.c), qp.c,
                      c_obj[:, None] * qp.c / E_c),
        lb=qp.lb * E_b, ub=qp.ub * E_b)
    return scaled, b_diag, _Scale(D=D, E_c=E_c, E_b=E_b, c_obj=c_obj)


class PreparedBlockQP(NamedTuple):
    """Scaled QP data + factorization, valid for any trust box."""

    sq: BlockQP          # scaled problem; its lb/ub fields are unused
    b_diag: torch.Tensor
    sc: _Scale
    rho_c: torch.Tensor
    rho_b: torch.Tensor
    Minv: torch.Tensor   # None between block_system and its inverse
    q_norm: torch.Tensor


def block_system(qp: BlockQP, cfg: ADMMConfig = ADMMConfig()
                 ) -> tuple[PreparedBlockQP, torch.Tensor]:
    """Everything of :func:`prepare_qp_block` before the inverse: the
    prepared QP with ``Minv`` unset, and the x-update system M = P +
    sigma I + C'R C + diag(rho_b b^2).  Syncs nothing with the host."""
    dtype, n = qp.P.dtype, qp.P.shape[-1]
    sq, b_diag, sc = _ruiz(qp, cfg.ruiz_iters)
    P2, q2, c2, c_obj2 = apply_dual_cost_scale(sq.P, sq.q, sq.c, sc.c_obj,
                                               cfg)
    sq = sq._replace(P=P2, q=q2, c=c2)
    sc = sc._replace(c_obj=c_obj2)

    hard_c = torch.isinf(sq.c)
    eq_c = (sq.u - sq.l) < 1e-10
    rho_c = torch.where(hard_c & eq_c,
                        torch.full_like(sq.c, cfg.rho * cfg.rho_eq_scale),
                        torch.full_like(sq.c, cfg.rho))
    rho_c = torch.clamp(rho_c, cfg.rho_min, cfg.rho_max)
    rho_b = torch.full_like(sq.q, cfg.rho)

    eye = torch.eye(n, dtype=dtype, device=qp.P.device)
    M = sq.P + cfg.sigma * eye + bb.at_r_a(sq.C, rho_c) \
        + torch.diag_embed(rho_b * b_diag * b_diag)
    return PreparedBlockQP(sq=sq, b_diag=b_diag, sc=sc, rho_c=rho_c,
                           rho_b=rho_b, Minv=None, q_norm=_inf(qp.q)), M


def invert_block_system(prep: PreparedBlockQP, M: torch.Tensor,
                        cfg: ADMMConfig = ADMMConfig(),
                        minv0: torch.Tensor | None = None
                        ) -> PreparedBlockQP:
    """``prep`` with ``Minv`` the inverse of M: by Cholesky, or with a
    seed ``minv0`` refreshed by safeguarded Newton-Schulz (whose loop
    syncs with the host)."""
    if minv0 is None:
        Minv = cholesky_inverse(M)
    else:
        Minv = ns_inverse(M, minv0, tol=cfg.ns_tol, max_iter=cfg.ns_max_iter,
                          power_iters=cfg.ns_power_iters,
                          coarse=cfg.ns_coarse)
    return prep._replace(Minv=Minv)


def prepare_qp_block(qp: BlockQP, cfg: ADMMConfig = ADMMConfig(),
                     minv0: torch.Tensor | None = None) -> PreparedBlockQP:
    """Equilibrate and factor the x-update system M = P + sigma I + C'R C
    + diag(rho_b b^2); with a seed ``minv0`` the inverse is refreshed by
    safeguarded Newton-Schulz instead of Cholesky."""
    return invert_block_system(*block_system(qp, cfg), cfg, minv0)


def chunk_operands(prep: PreparedBlockQP, lb, ub, x0, zc0=None, zb0=None,
                   yc0=None, yb0=None):
    """(consts, state): the scaled operands of ``fused_block.chunk`` in
    its argument order -- 15 per-QP constants, then the ADMM state
    (x, zc, zb, yc, yb).  Warm starts arrive unscaled in block row
    order; a missing one starts at C x0, B x0 or zero."""
    sq, b_diag, sc = prep.sq, prep.b_diag, prep.sc
    B, n, m = sq.P.shape[0], sq.C.plan.n, sq.C.plan.m_blk
    dtype = sq.P.dtype
    x = x0.to(dtype) / sc.D
    zc = bb.matvec(sq.C, x) if zc0 is None else zc0.to(dtype) * sc.E_c
    zb = b_diag * x if zb0 is None else zb0.to(dtype) * sc.E_b
    yc = (x.new_zeros(B, m) if yc0 is None
          else yc0.to(dtype) * (sc.c_obj[:, None] / sc.E_c))
    yb = (x.new_zeros(B, n) if yb0 is None
          else yb0.to(dtype) * (sc.c_obj[:, None] / sc.E_b))
    cr_c = torch.where(torch.isinf(sq.c), sq.c, sq.c / prep.rho_c)
    consts = tuple(t.contiguous() for t in (
        prep.Minv, sq.C.Wb, sq.P, sq.q, sq.l, sq.u, cr_c, prep.rho_c,
        lb * sc.E_b, ub * sc.E_b, b_diag, sc.E_c, sc.E_b, sc.D, sc.c_obj))
    return consts, (x, zc, zb, yc, yb)


def solve_qp_block_prepared(prep: PreparedBlockQP, lb, ub, x0, zc0=None,
                            zb0=None, yc0=None, yb0=None,
                            cfg: ADMMConfig = ADMMConfig(),
                            active=None) -> ADMMResult:
    """ADMM iterations on a prepared QP with box bounds [lb, ub], every
    chunk (``check_every`` iterations + residual statistics) one
    ``fused_block.chunk``.  A lane runs chunks while it is active, not
    converged and under ``max_iter`` (the per-lane while_loop of the JAX
    version); lanes with ``active`` False are not iterated and keep their
    warm start."""
    sc = prep.sc
    consts, state = chunk_operands(prep, lb, ub, x0, zc0, zb0, yc0, yb0)
    x = state[0]
    B = x.shape[0]
    iters = torch.zeros(B, dtype=torch.int32, device=x.device)
    pri = x.new_full((B,), float("inf"))
    dua = x.new_full((B,), float("inf"))
    conv = torch.zeros(B, dtype=torch.bool, device=x.device)
    live = torch.ones_like(conv) if active is None else active.clone()
    run = live & ~conv & (iters < cfg.max_iter)
    # The live lanes as int32 step ``iters``, and their sum is the loop's one
    # host read a chunk (a sum of the bool mask would cast it first).
    on = run.to(iters.dtype)
    n_run = host_read("qp", "block_chunk", int, on.sum(dtype=on.dtype))
    count("qp.admm.lane_solves", n_run)
    while n_run:
        count("qp.admm.lane_iters", n_run * cfg.check_every)
        # The kernel takes rho_b as the scalar cfg.rho: prepare_qp_block
        # builds rho_b as that uniform value.
        state, st = fused_block.chunk(
            *consts, *state, D=prep.sq.C.plan.D, sigma=cfg.sigma,
            alpha=cfg.alpha, rho_b=cfg.rho, n_iters=cfg.check_every,
            active=run)
        eps_pri = cfg.eps_abs + cfg.eps_rel * torch.maximum(st.ax_n, st.z_n)
        eps_dua = cfg.eps_abs + cfg.eps_rel * torch.maximum(st.pAty_n,
                                                            prep.q_norm)
        c_new = (st.pri <= eps_pri) & (st.dua <= eps_dua)
        pri = torch.where(run, st.pri, pri)
        dua = torch.where(run, st.dua, dua)
        conv = torch.where(run, c_new, conv)
        iters = torch.add(iters, on, alpha=cfg.check_every)
        run = live & ~conv & (iters < cfg.max_iter)
        on = run.to(iters.dtype)
        n_run = host_read("qp", "block_chunk", int, on.sum(dtype=on.dtype))
    x, zc, zb, yc, yb = state
    cobj = sc.c_obj[:, None]
    return ADMMResult(
        x=x * sc.D,
        z=torch.cat([zc / sc.E_c, zb / sc.E_b], -1),
        y=torch.cat([yc * (sc.E_c / cobj), yb * (sc.E_b / cobj)], -1),
        iters=iters, pri_res=pri, dua_res=dua, converged=conv)


def solve_qp_block(qp: BlockQP, x0, zc0=None, zb0=None, yc0=None, yb0=None,
                   cfg: ADMMConfig = ADMMConfig()) -> ADMMResult:
    """One-shot prepare + solve (box bounds from ``qp.lb``/``qp.ub``)."""
    return solve_qp_block_prepared(prepare_qp_block(qp, cfg), qp.lb, qp.ub,
                                   x0, zc0=zc0, zb0=zb0, yc0=yc0, yb0=yb0,
                                   cfg=cfg)
