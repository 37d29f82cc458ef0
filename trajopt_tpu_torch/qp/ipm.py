"""Primal-dual interior-point QP solver (Mehrotra predictor-corrector), on
batches of dense QPs.

Counterpart of ``trajopt_tpu/qp/ipm.py``, the second QP algorithm beside
ADMM (``SQPParams.qp_algorithm="ipm"`` on the dense path).  The prox-form
QP ``min 0.5 x'Px + q'x + sum_i c_i dist(A_i x, [l_i, u_i])`` is lifted to
the epigraph QP over w = (x, t)::

    minimize 0.5 x'Px + q'x + c_eff' t
    s.t.     A x - t <= u   (lam_u),   -A x - t <= -l   (lam_l),   -t <= 0

with ``c_eff = c`` on finite rows and a data-derived big-M on hard rows
(c = inf).  One-sided rows are masked out of their barrier block (lam = 0,
s = 1 for ever), and a lane reports converged only when every hard row's
slack t is below ``hard_tol``, so big-M inexactness cannot pass as success.
Each Newton step solves the dense (n+m) x (n+m) reduced system by a
batched Cholesky (``torch.linalg.cholesky_ex``; a lane whose system is not
positive definite gets NaN, as JAX's factorization gives, and the step
guard ends it).

The JAX function solves one problem and is batched by ``vmap`` over its
``while_loop``; here every lane steps while any lane is live, and a lane
that has converged or run out of steps keeps its state (the step is
computed for the whole batch and not taken), so a lane's result does not
depend on its neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from trajopt_tpu_torch.qp.admm import ADMMResult, QPData


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Solver configuration; see the JAX counterpart for the reasoning
    behind each default (``eps``: complementarity target; ``eps_res``:
    relative KKT residual gate; ``big_m``: floor of the hard-row weight;
    ``hard_tol``: hard-row slack gate; ``reg``: Tikhonov on the reduced
    system; ``tau``: fraction to the boundary)."""

    max_iter: int = 50
    eps: float = 1e-8
    eps_res: float = 1e-3
    big_m: float = 1e4
    hard_tol: float = 1e-6
    reg: float = 1e-11
    tau: float = 0.995
    min_mu: float = 1e-12


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _apply_G(A, x, t):
    """G w for the three stacked blocks: (Ax - t, -Ax - t, -t)."""
    Ax = _mv(A, x)
    return Ax - t, -Ax - t, -t


def _apply_GT(A, lu, ll, lt):
    """G' lam, split into its x and t parts."""
    return _mv(A.transpose(-1, -2), lu - ll), -(lu + ll + lt)


def _amax(v):
    return torch.amax(v, -1)


def _dot(a, b):
    return (a * b).sum(-1)


def solve_qp_ipm(qp: QPData, x0: torch.Tensor | None = None,
                 cfg: IPMConfig = IPMConfig()) -> ADMMResult:
    """Solve a batch of prox-form QPs by primal-dual IPM.

    Returns an ``ADMMResult`` for use where ``solve_qp``'s is expected:
    ``z = A x``, ``y`` the interval-row dual ``lam_u - lam_l`` (the
    multiplier ADMM's y converges to), ``iters`` the Newton steps (
    ``max_iter`` for a lane a failed step ended), ``pri_res`` the scaled
    KKT residual and ``dua_res`` the complementarity gap mu."""
    P, q, A = qp.P, qp.q, qp.A
    B, m, n = A.shape
    dtype, dev = P.dtype, P.device
    hard = ~torch.isfinite(qp.c)
    zero = torch.zeros_like(qp.c)
    c_fin_max = _amax(torch.where(hard, zero, qp.c)).clamp_min(0.0)
    q_max = _amax(torch.abs(q))
    big_m = torch.clamp_min(10.0 * torch.maximum(c_fin_max, q_max),
                            cfg.big_m)
    c_eff = torch.where(hard, big_m[:, None].expand_as(qp.c), qp.c)

    mask_u = torch.isfinite(qp.u)
    mask_l = torch.isfinite(qp.l)
    u_s = torch.where(mask_u, qp.u, zero)
    l_s = torch.where(mask_l, qp.l, zero)
    mask = torch.cat([mask_u, mask_l, torch.ones_like(mask_u)], -1)
    n_act = (mask_u.sum(-1) + mask_l.sum(-1) + m).to(dtype)

    # Strictly interior start, duals on the t-stationarity manifold.
    x = q.new_zeros(B, n) if x0 is None else x0.to(dtype)
    Ax = _mv(A, x)
    viol = torch.maximum(torch.where(mask_u, Ax - u_s, zero),
                         torch.where(mask_l, l_s - Ax, zero))
    t = torch.clamp_min(viol, 0.0) + 1.0
    w = torch.cat([x, t], -1)
    n_blocks = mask_u.to(dtype) + mask_l.to(dtype) + 1.0
    lam1 = torch.clamp_min(c_eff / n_blocks, 1e-3)
    lam = torch.cat([lam1, lam1, lam1], -1)
    su, sl, st = _apply_G(A, x, t)
    s = torch.cat([u_s - su, -l_s - sl, -st], -1)
    lam = torch.where(mask, lam, torch.zeros_like(lam))
    s = torch.where(mask, s, torch.ones_like(s))

    h_scale = 1.0 + torch.maximum(_amax(torch.abs(u_s)),
                                  _amax(torch.abs(l_s)))
    # Per-block dual scales: x-stationarity by the gradient data,
    # t-stationarity by the (possibly big-M) penalty weights.
    g_scale = torch.cat([(1.0 + q_max)[:, None].expand(B, n),
                         (1.0 + _amax(c_eff))[:, None].expand(B, m)], -1)
    eye = torch.eye(n + m, dtype=dtype, device=dev)

    def residuals(w, lam, s):
        x, t = w[:, :n], w[:, n:]
        gx, gt = _apply_GT(A, lam[:, :m], lam[:, m:2 * m], lam[:, 2 * m:])
        r_dx = _mv(P, x) + q + gx
        r_dt = c_eff + gt
        gu, gl, gtt = _apply_G(A, x, t)
        r_p = torch.cat([gu + s[:, :m] - u_s, gl + s[:, m:2 * m] + l_s,
                         gtt + s[:, 2 * m:]], -1)
        return (torch.cat([r_dx, r_dt], -1),
                torch.where(mask, r_p, torch.zeros_like(r_p)))

    def res_norm(r_d, r_p):
        return torch.maximum(_amax(torch.abs(r_d) / g_scale),
                             _amax(torch.abs(r_p)) / h_scale)

    def max_step(v, dv):
        """Largest a in (0, 1] with v + a dv >= (1 - tau) v, per lane."""
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(
            dv)), torch.full_like(v, float("inf")))
        return torch.clamp_max(cfg.tau * torch.amin(ratio, -1), 1.0)

    def step(w, lam, s):
        lam_s = lam / s
        du, dl, dt_ = lam_s[:, :m], lam_s[:, m:2 * m], lam_s[:, 2 * m:]
        # Reduced Hessian K = blkdiag(P, 0) + G' diag(lam/s) G:
        # Kxx = P + A'(du+dl)A, Kxt = -A'(du-dl), Ktt = diag(du+dl+dt).
        dsum = du + dl
        At = A.transpose(-1, -2)
        Kxx = P + At @ (dsum[..., None] * A)
        Kxt = -(At * (du - dl)[:, None, :])
        K = torch.cat([torch.cat([Kxx, Kxt], -1),
                       torch.cat([Kxt.transpose(-1, -2),
                                  torch.diag_embed(dsum + dt_)], -1)], -2)
        K = K + cfg.reg * eye
        L, info = torch.linalg.cholesky_ex(K)
        L = torch.where((info == 0)[:, None, None], L,
                        torch.full_like(L, float("nan")))

        def cho_solve(b):
            return torch.cholesky_solve(b[..., None], L)[..., 0]

        r_d, r_p = residuals(w, lam, s)
        mu = _dot(lam, s) / n_act

        def newton(r_c):
            # ds = -(r_p + G dw);  dlam = -(r_c + Lam ds) / s
            # => K dw = -r_d + G'((r_c - Lam r_p) / s)
            corr = (r_c - lam * r_p) / s
            gx, gt = _apply_GT(A, corr[:, :m], corr[:, m:2 * m],
                               corr[:, 2 * m:])
            rhs = -r_d + torch.cat([gx, gt], -1)
            dw = cho_solve(rhs)
            # one round of iterative refinement
            dw = dw + cho_solve(rhs - _mv(K, dw))
            gu, gl, gtt = _apply_G(A, dw[:, :n], dw[:, n:])
            ds = torch.where(mask, -(r_p + torch.cat([gu, gl, gtt], -1)),
                             torch.zeros_like(r_p))
            return dw, -(r_c + lam * ds) / s, ds

        # Predictor (affine scaling): target complementarity 0.
        dw_a, dlam_a, ds_a = newton(lam * s)
        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dlam_a)
        mu_aff = _dot(lam + a_d[:, None] * dlam_a,
                      s + a_p[:, None] * ds_a) / n_act
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, cfg.min_mu)) ** 3,
                            0.0, 1.0)
        # Corrector: centring plus Mehrotra's second-order term (masked
        # rows keep r_c = 0).
        r_c = torch.where(mask, lam * s + dlam_a * ds_a
                          - (sigma * mu)[:, None], torch.zeros_like(lam))
        dw_c, dlam_c, ds_c = newton(r_c)
        a_p = max_step(s, ds_c)[:, None]
        a_d = max_step(lam, dlam_c)[:, None]
        return w + a_p * dw_c, lam + a_d * dlam_c, s + a_p * ds_c

    r_d0, r_p0 = residuals(w, lam, s)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    mu = _dot(lam, s) / n_act
    res = res_norm(r_d0, r_p0)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    run = ~converged & (iters < cfg.max_iter)
    while bool(run.any()):
        w_n, lam_n, s_n = step(w, lam, s)
        r_d_n, r_p_n = residuals(w_n, lam_n, s_n)
        mu_n = _dot(lam_n, s_n) / n_act
        res_n = res_norm(r_d_n, r_p_n)
        t_hard = _amax(torch.where(hard, w_n[:, n:],
                                   torch.zeros_like(w_n[:, n:])))
        conv = ((mu_n <= cfg.eps * 10.0) & (res_n <= cfg.eps_res)
                & (t_hard <= cfg.hard_tol * h_scale))
        # A non-finite or boundary-crossing step keeps the previous iterate,
        # reports not converged and ends the lane (masked rows sit at
        # (lam, s) = (0, 1) and are left out of the positivity check).
        one = torch.ones_like(s_n)
        ok = (torch.isfinite(w_n).all(-1) & torch.isfinite(lam_n).all(-1)
              & (torch.where(mask, s_n, one) > 0).all(-1)
              & (torch.where(mask, lam_n, one) > 0).all(-1))
        ok = ok & run
        halt = run & ~ok
        o = ok[:, None]
        w = torch.where(o, w_n, w)
        lam = torch.where(o, lam_n, lam)
        s = torch.where(o, s_n, s)
        iters = torch.where(halt, torch.full_like(iters, cfg.max_iter),
                            iters + run.to(iters.dtype))
        mu = torch.where(ok, mu_n, mu)
        res = torch.where(ok, res_n, res)
        converged = torch.where(ok, conv, converged)
        run = ~converged & (iters < cfg.max_iter)

    x = w[:, :n]
    return ADMMResult(x=x, z=_mv(A, x), y=lam[:, :m] - lam[:, m:2 * m],
                      iters=iters, pri_res=res, dua_res=mu,
                      converged=converged)
