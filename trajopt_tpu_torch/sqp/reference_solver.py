"""Host-side reference SQP driver: a plain Python loop + the native C++ QP.

Counterpart of ``trajopt_tpu/sqp/reference_solver.py``.  Role: an
independent execution path for trajectory-parity validation (the
reference validates across 4 QP backends, small-problems-unit.cpp:184;
here the batched solver is held against this straightforward
transcription of the same algorithm with the host C++ ADMM).  Also useful
for debugging: every iteration is steppable host code.

It shares convexification and evaluation with the batched solver (the same
code, so parity failures isolate the loop and QP logic, not the models).
Those run as one lane on ``device`` (None: CUDA, raising when there is
none; float32 on the card, float64 on the CPU unless ``dtype`` says
otherwise); each trust-region QP ``[A_cnt; A_pen; I]`` runs on the host in
float64 (``qp/native.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from trajopt_tpu_torch import resolve_device, resolve_dtype
from trajopt_tpu_torch.qp.native import solve_qp_native
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.nlp import Nlp
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.solver import _cnt_row_coeffs, _penalty_cost_rows
from trajopt_tpu_torch.utils.cache import LRUCache, joint_hash


@dataclasses.dataclass
class RefResult:
    x: np.ndarray
    status: int
    cost_vals: np.ndarray
    cnt_viols: np.ndarray
    n_iter: int
    n_qp_solves: int


def _host(t: torch.Tensor) -> np.ndarray:
    """Lane 0 of a device tensor as a float64 numpy array."""
    return t[0].detach().to("cpu", torch.float64).numpy()


def solve_reference(nlp: Nlp, x0, lb, ub, params: Any = None,
                    sqp: SQPParams = SQPParams(), device=None,
                    dtype=None) -> RefResult:
    """Solve one problem from ``x0 [n]`` within bounds ``lb``, ``ub``
    ``[n]``; ``params`` are one lane's entries, without the lane axis (a
    tensor or a tuple of them each)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dev, dtype)

    def lane(v):
        v = torch.as_tensor(v, device=dev)
        return (v.to(dtype) if v.is_floating_point() else v)[None]

    p1 = {k: tuple(lane(e) for e in v) if isinstance(v, tuple) else lane(v)
          for k, v in (params or {}).items()}
    lb = np.asarray(torch.as_tensor(lb).cpu(), float).reshape(-1)
    ub = np.asarray(torch.as_tensor(ub).cpu(), float).reshape(-1)
    x = np.clip(np.asarray(torch.as_tensor(x0).cpu(), float).reshape(-1),
                lb, ub)
    n = nlp.n
    n_cnt = nlp_mod.num_cnt_groups(nlp)

    def on_dev(xv):
        return torch.as_tensor(xv, dtype=dtype, device=dev)[None]

    # Hash-keyed LRU over exact evaluations, the role the collision-result
    # cache plays in the reference's merit loop
    # (CollisionEvaluator::GetContactResultCached, collision_terms.cpp:440).
    _exact_cache = LRUCache(capacity=4)

    def exact(xv):
        def compute():
            xd = on_dev(xv)
            return (_host(nlp_mod.eval_exact_costs(nlp, xd, p1)),
                    _host(nlp_mod.eval_exact_cnt_viols(nlp, xd, p1)))

        return _exact_cache.get_or_acquire(joint_hash(xv), compute)

    cost_vals, cnt_viols = exact(x)
    merit_coeffs = np.full(n_cnt, sqp.initial_merit_error_coeff)
    box = sqp.initial_trust_box_size
    n_qp = 0
    total_iter = 0
    t_start = time.monotonic()

    def merit(cv, viols, mc):
        return float(cv.sum() + (mc * viols).sum())

    for merit_round in range(sqp.max_merit_coeff_increases):
        converged_small = False
        for it in range(1, sqp.max_iter + 1):
            # Wall-clock budget (optimizers.cpp max_time check at the top
            # of each SQP iteration -> OPT_TIME_LIMIT).
            if time.monotonic() - t_start > sqp.max_time:
                return RefResult(x, SQPStatus.TIME_LIMIT, cost_vals,
                                 cnt_viols, total_iter, n_qp)
            total_iter += 1
            xd = on_dev(x)
            m = nlp_mod.convexify(nlp, xd, p1)
            A_pen, l_pen, u_pen, c_pen = _penalty_cost_rows(nlp, m)
            A = np.concatenate([_host(m.A_cnt), _host(A_pen), np.eye(n)])
            mc = torch.as_tensor(merit_coeffs, dtype=dtype, device=dev)
            row_c = np.concatenate([_host(_cnt_row_coeffs(nlp, mc[None])),
                                    _host(c_pen), np.full(n, np.inf)])
            P, q = _host(m.P), _host(m.q)
            l_cnt = _host(m.l_cnt - m.b_cnt)
            u_cnt = _host(m.u_cnt - m.b_cnt)
            l_pen, u_pen = _host(l_pen), _host(u_pen)
            old_merit = merit(cost_vals, cnt_viols, merit_coeffs)

            while box >= sqp.min_trust_box_size:
                lb_box = np.maximum(lb, x - box)
                ub_box = np.minimum(ub, x + box)
                l = np.concatenate([l_cnt, l_pen, lb_box])
                u = np.concatenate([u_cnt, u_pen, ub_box])
                res = solve_qp_native(P, q, A, l, u, row_c, x0=x,
                                      eps_abs=sqp.qp.eps_abs,
                                      eps_rel=sqp.qp.eps_rel,
                                      max_iter=4 * sqp.qp.max_iter)
                n_qp += 1
                new_x = res.x
                xn = on_dev(new_x)
                model_cost = float(nlp_mod.model_cost_total(nlp, m, xn)[0])
                model_viols = _host(nlp_mod.eval_model_cnt_viols(nlp, m, xn))
                model_merit = model_cost + float(
                    (merit_coeffs * model_viols).sum())
                new_cost, new_viols = exact(new_x)
                new_merit = merit(new_cost, new_viols, merit_coeffs)
                approx = old_merit - model_merit
                exact_imp = old_merit - new_merit
                if approx < sqp.min_approx_improve:
                    converged_small = True
                    break
                if exact_imp <= 0 or \
                        exact_imp / approx < sqp.improve_ratio_threshold:
                    box *= sqp.trust_shrink_ratio
                    continue
                x, cost_vals, cnt_viols = new_x, new_cost, new_viols
                box *= sqp.trust_expand_ratio
                break

            if converged_small or box < sqp.min_trust_box_size:
                break
            if it >= sqp.max_iter:
                ok = cnt_viols.size == 0 or \
                    cnt_viols.max() < sqp.cnt_tolerance
                return RefResult(x, SQPStatus.CONVERGED if ok
                                 else SQPStatus.SCO_ITERATION_LIMIT,
                                 cost_vals, cnt_viols, total_iter, n_qp)

        if cnt_viols.size == 0 or cnt_viols.max() < sqp.cnt_tolerance:
            return RefResult(x, SQPStatus.CONVERGED, cost_vals, cnt_viols,
                             total_iter, n_qp)
        if sqp.inflate_constraints_individually:
            merit_coeffs = np.where(
                cnt_viols > sqp.cnt_tolerance,
                merit_coeffs * sqp.merit_coeff_increase_ratio, merit_coeffs)
        else:
            merit_coeffs *= sqp.merit_coeff_increase_ratio
        box = max(box, sqp.min_trust_box_size / sqp.trust_shrink_ratio * 1.5)

    return RefResult(x, SQPStatus.PENALTY_ITERATION_LIMIT, cost_vals,
                     cnt_viols, total_iter, n_qp)
