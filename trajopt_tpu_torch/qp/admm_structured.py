"""Structured prox-ADMM: constraint matrix = [banded rows; identity box], on
batches.

Counterpart of ``trajopt_tpu/qp/admm_structured.py``, the QP of the SQP
driver's gather-banded path (``structured=True`` where the row windows are
not step-aligned).  The iteration is the dense solver's (``qp/admm.py``)
with banded matvecs for the constraint block and elementwise ops for the
identity block; the x-update system M = P + sigma I + C'R C + diag(rho_b
b^2) is factored once per solve (fixed rho).  The JAX function solves one
problem and is batched by ``vmap`` over its ``while_loop``; here a lane
runs chunks of ``check_every`` iterations while it is not converged and
under ``max_iter``, and a finished lane keeps its state.  The JAX package
has no Pallas kernel here: its iterations are XLA-fused, and the port's
are plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trajopt_tpu_torch.qp import banded as bd
from trajopt_tpu_torch.qp.admm import (ADMMConfig, ADMMResult, _inf_norm,
                                       _inv_sqrt, _prox_dist,
                                       apply_dual_cost_scale)
from trajopt_tpu_torch.qp.inverse import cholesky_inverse


class StructuredQP(NamedTuple):
    """min 0.5 x'Px + q'x + sum_i c_i dist((Cx)_i, [l,u]) + box(x in
    [lb,ub]) per lane: P [B,n,n], q [B,n], C banded [B,m,n], l, u, c [B,m]
    (c = inf: hard), lb, ub [B,n]."""

    P: torch.Tensor
    q: torch.Tensor
    C: bd.BandedMatrix
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


def _ruiz(qp: StructuredQP, iters: int):
    """OSQP's modified Ruiz equilibration of [C; I] plus cost scaling (the
    dense ``ruiz_equilibrate`` with the identity block kept diagonal)."""
    P, q, C = qp.P, qp.q, qp.C
    B, n = q.shape
    b_diag = q.new_ones(B, n)
    D = q.new_ones(B, n)
    E_c = q.new_ones(B, C.m)
    E_b = q.new_ones(B, n)
    c_obj = q.new_ones(B)
    for _ in range(iters):
        col = torch.maximum(torch.amax(torch.abs(P), -2),
                            torch.maximum(bd.col_inf_norms(C),
                                          torch.abs(b_diag)))
        d = _inv_sqrt(col)
        P = d[:, :, None] * P * d[:, None, :]
        q = d * q
        C = bd.scale_cols(C, d)
        b_diag = b_diag * d
        e_c = _inv_sqrt(bd.row_inf_norms(C))
        C = bd.scale_rows(C, e_c)
        e_b = _inv_sqrt(torch.abs(b_diag))
        b_diag = b_diag * e_b
        g_den = torch.maximum(torch.mean(torch.amax(torch.abs(P), -2), -1),
                              torch.amax(torch.abs(q), -1))
        g = torch.where(g_den < 1e-12, torch.ones_like(g_den), 1.0 / g_den)
        P, q = g[:, None, None] * P, g[:, None] * q
        c_obj = c_obj * g
        D, E_c, E_b = D * d, E_c * e_c, E_b * e_b
    scaled = StructuredQP(
        P=P, q=q, C=C, l=qp.l * E_c, u=qp.u * E_c,
        c=torch.where(torch.isinf(qp.c), qp.c, c_obj[:, None] * qp.c / E_c),
        lb=qp.lb * E_b, ub=qp.ub * E_b)
    return scaled, b_diag, _Scale(D=D, E_c=E_c, E_b=E_b, c_obj=c_obj)


def solve_qp_structured(qp: StructuredQP, x0, zc0=None, zb0=None, yc0=None,
                        yb0=None, cfg: ADMMConfig = ADMMConfig()
                        ) -> ADMMResult:
    """Solve a batch of structured QPs, warm-started from (x0, z, y) in
    unscaled units.  Returns an ``ADMMResult`` with z = [z_c, z_b] and y
    likewise (the dense solver's row order [C; I])."""
    n = qp.P.shape[-1]
    orig_q = qp.q
    sq, b_diag, sc = _ruiz(qp, cfg.ruiz_iters)
    # The dual-magnitude rescale comes before the warm-start dual scaling
    # below, which must use the final c_obj.
    P2, q2, c2, c_obj2 = apply_dual_cost_scale(sq.P, sq.q, sq.c, sc.c_obj,
                                               cfg)
    sq = sq._replace(P=P2, q=q2, c=c2)
    sc = sc._replace(c_obj=c_obj2)
    cobj = sc.c_obj[:, None]
    dtype = sq.P.dtype

    x = x0.to(dtype) / sc.D
    zc = bd.matvec(sq.C, x) if zc0 is None else zc0.to(dtype) * sc.E_c
    zb = b_diag * x if zb0 is None else zb0.to(dtype) * sc.E_b
    yc = (torch.zeros_like(sq.l) if yc0 is None
          else yc0.to(dtype) * (cobj / sc.E_c))
    yb = (torch.zeros_like(x) if yb0 is None
          else yb0.to(dtype) * (cobj / sc.E_b))

    hard_c = torch.isinf(sq.c)
    eq_c = (sq.u - sq.l) < 1e-10
    rho_c = torch.where(hard_c & eq_c,
                        torch.full_like(sq.c, cfg.rho * cfg.rho_eq_scale),
                        torch.full_like(sq.c, cfg.rho))
    rho_c = torch.clamp(rho_c, cfg.rho_min, cfg.rho_max)
    rho_b = torch.full_like(x, cfg.rho)

    # Fixed rho: one dense factorization per solve.
    eye = torch.eye(n, dtype=dtype, device=x.device)
    Minv = cholesky_inverse(sq.P + cfg.sigma * eye + bd.at_r_a(sq.C, rho_c)
                            + torch.diag_embed(rho_b * b_diag * b_diag))

    q_norm = _inf_norm(orig_q)
    alpha, sigma = cfg.alpha, cfg.sigma
    cr_c = torch.where(hard_c, sq.c, sq.c / rho_c)
    inf_b = torch.full_like(x, float("inf"))

    def admm_iter(x, zc, zb, yc, yb):
        rhs = sigma * x - sq.q + bd.rmatvec(sq.C, rho_c * zc - yc) \
            + b_diag * (rho_b * zb - yb)
        xt = (Minv @ rhs[..., None])[..., 0]
        ztc = bd.matvec(sq.C, xt)
        ztb = b_diag * xt
        x_new = alpha * xt + (1.0 - alpha) * x
        zrc = alpha * ztc + (1.0 - alpha) * zc
        zrb = alpha * ztb + (1.0 - alpha) * zb
        zc_new = _prox_dist(zrc + yc / rho_c, sq.l, sq.u, cr_c)
        zb_new = _prox_dist(zrb + yb / rho_b, sq.lb, sq.ub, inf_b)
        return (x_new, zc_new, zb_new, yc + rho_c * (zrc - zc_new),
                yb + rho_b * (zrb - zb_new))

    B = x.shape[0]
    cD = cobj * sc.D
    iters = torch.zeros(B, dtype=torch.int32, device=x.device)
    pri = x.new_full((B,), float("inf"))
    dua = x.new_full((B,), float("inf"))
    conv = torch.zeros(B, dtype=torch.bool, device=x.device)
    state = (x, zc, zb, yc, yb)
    run = ~conv & (iters < cfg.max_iter)
    while bool(run.any()):
        new = state
        for _ in range(cfg.check_every):
            new = admm_iter(*new)
        x, zc, zb, yc, yb = new
        Cx = bd.matvec(sq.C, x)
        Bx = b_diag * x
        Px = (sq.P @ x[..., None])[..., 0]
        Aty = bd.rmatvec(sq.C, yc) + b_diag * yb
        # Unscaled residuals (OSQP's termination units).
        p_new = torch.maximum(_inf_norm((Cx - zc) / sc.E_c),
                              _inf_norm((Bx - zb) / sc.E_b))
        d_new = _inf_norm((Px + sq.q + Aty) / cD)
        ax_n = torch.maximum(_inf_norm(Cx / sc.E_c), _inf_norm(Bx / sc.E_b))
        z_n = torch.maximum(_inf_norm(zc / sc.E_c), _inf_norm(zb / sc.E_b))
        eps_pri = cfg.eps_abs + cfg.eps_rel * torch.maximum(ax_n, z_n)
        eps_dua = cfg.eps_abs + cfg.eps_rel * torch.maximum(
            torch.maximum(_inf_norm(Px / cD), _inf_norm(Aty / cD)), q_norm)
        r = run[:, None]
        state = tuple(torch.where(r, a, b) for a, b in zip(new, state))
        pri = torch.where(run, p_new, pri)
        dua = torch.where(run, d_new, dua)
        conv = torch.where(run, (p_new <= eps_pri) & (d_new <= eps_dua),
                           conv)
        iters = iters + run.to(iters.dtype) * cfg.check_every
        run = ~conv & (iters < cfg.max_iter)
    x, zc, zb, yc, yb = state
    return ADMMResult(
        x=x * sc.D,
        z=torch.cat([zc / sc.E_c, zb / sc.E_b], -1),
        y=torch.cat([yc * (sc.E_c / cobj), yb * (sc.E_b / cobj)], -1),
        iters=iters, pri_res=pri, dua_res=dua, converged=conv)
