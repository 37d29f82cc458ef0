"""Time-parameterized terms (TT_USE_TIME): velocity and acceleration with
a 1/dt column, and the total-trajectory-time term, on batched
trajectories.

Counterpart of ``trajopt_tpu/terms/time.py`` (the reference's
``JointVelErrCalculator`` / ``JointAccErrCalculator`` /
``TimeCostCalculator``).  The decision matrix is ``[n_steps, n_dof + 1]``
per lane; its last column holds 1/dt.

* joint_vel + time: ``vel[t] = (x[t+1] - x[t]) * inv_dt[t+1]``, two rows
  per (t, dof): ``vel - target - upper_tol`` and ``lower_tol - (vel -
  target)``.
* joint_acc + time: ``acc[t] = 2 (vel[t+1] - vel[t]) / (inv_dt[t+1] +
  inv_dt[t+2])``, as the reference writes it.
* total_time: ``sum(1 / inv_dt) - limit``; squared when limit == 0, hinge
  otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.sqp.nlp import Kind, TermSet
from trajopt_tpu_torch.terms.joint import _resolve


def _tiled_weight(coeffs, n_dof, reps):
    """weight_fn: per-dof coeffs (a vector or a params key) tiled over
    ``reps`` row blocks."""
    def weight_fn(params):
        c = np.ones(n_dof) if coeffs is None else coeffs
        if isinstance(c, str):
            return torch.tile(params[c], (reps,))
        return np.tile(np.broadcast_to(np.asarray(c, float), (n_dof,)),
                       reps)
    return weight_fn


def joint_vel_time(n_steps: int, n_dof: int, *, is_cost: bool = True,
                   targets=None, coeffs=None, upper_tols=None,
                   lower_tols=None, first_step: int = 0,
                   last_step: int = -1,
                   name: str = "joint_vel_time") -> TermSet:
    """Velocity term with 1/dt scaling; always the doubled upper/lower
    rows of JointVelErrCalculator."""
    n_dt = n_dof + 1
    if last_step <= -1:
        last_step = n_steps - 1
    first, last = first_step, last_step
    n_t = last - first
    has_tols = upper_tols is not None or lower_tols is not None

    def rows(x, params):
        m = x.reshape(x.shape[0], n_steps, n_dt)
        q = m[..., :n_dof]
        inv_dt = m[..., n_dof]
        zeros = np.zeros(n_dof)
        # constants are kept on this function, which lives with the term
        t = _resolve(targets, params, n_dof, x, zeros, rows)[..., None, :]
        up = _resolve(upper_tols, params, n_dof, x, zeros, rows)[..., None, :]
        lo = _resolve(lower_tols, params, n_dof, x, zeros, rows)[..., None, :]
        vel = (q[:, first + 1:last + 1] - q[:, first:last]) * \
            inv_dt[:, first + 1:last + 1, None]
        upper = vel - t - up
        lower = lo - (vel - t)
        B = x.shape[0]
        return torch.cat([upper.reshape(B, -1), lower.reshape(B, -1)], -1)

    n_rows = 2 * n_t * n_dof
    if is_cost:
        kind = Kind.COST_HINGE if has_tols else Kind.COST_SQ
        return TermSet(name, kind, rows, n_rows,
                       weight_fn=_tiled_weight(coeffs, n_dof, 2 * n_t))

    def fn(x, params):
        c = _resolve(coeffs, params, n_dof, x, np.ones(n_dof), rows)
        return rows(x, params) * torch.tile(c, (2 * n_t,))

    return TermSet(name, Kind.CNT_INEQ if has_tols else Kind.CNT_EQ, fn,
                   n_rows)


def joint_acc_time(n_steps: int, n_dof: int, *, is_cost: bool = True,
                   limit: float = 0.0, coeffs=None, first_step: int = 0,
                   last_step: int = -1,
                   name: str = "joint_acc_time") -> TermSet:
    n_dt = n_dof + 1
    if last_step <= -1:
        last_step = n_steps - 1
    first, last = first_step, last_step
    n_t = last - first - 1

    def rows(x, params):
        m = x.reshape(x.shape[0], n_steps, n_dt)
        q = m[:, first:last + 1, :n_dof]
        inv_dt = m[:, first:last + 1, n_dof]
        vel = (q[:, 1:] - q[:, :-1]) * inv_dt[:, 1:, None]
        vel_diff = vel[:, 1:] - vel[:, :-1]
        acc = 2.0 * vel_diff / (inv_dt[:, 1:-1] + inv_dt[:, 2:])[..., None]
        return (acc - limit).reshape(x.shape[0], -1)

    n_rows = n_t * n_dof
    if is_cost:
        return TermSet(name, Kind.COST_SQ, rows, n_rows,
                       weight_fn=_tiled_weight(coeffs, n_dof, n_t))

    def fn(x, params):
        c = _resolve(coeffs, params, n_dof, x, np.ones(n_dof), rows)
        return rows(x, params) * torch.tile(c, (n_t,))

    return TermSet(name, Kind.CNT_EQ, fn, n_rows)


def total_time(n_steps: int, n_dof: int, *, is_cost: bool = True,
               coeff: float = 1.0, limit: float = 0.0,
               name: str = "total_time") -> TermSet:
    """Sum of dt (= sum 1/inv_dt) relative to ``limit``
    (TotalTimeTermInfo)."""
    n_dt = n_dof + 1

    def fn(x, params):
        inv_dt = x.reshape(x.shape[0], n_steps, n_dt)[..., n_dof]
        return (1.0 / inv_dt).sum(-1, keepdim=True) - limit

    hinge = not np.isclose(limit, 0.0)
    if is_cost:
        return TermSet(name, Kind.COST_HINGE if hinge else Kind.COST_SQ, fn,
                       1, weight_fn=lambda p: coeff)
    return TermSet(name, Kind.CNT_INEQ if hinge else Kind.CNT_EQ,
                   lambda x, p: fn(x, p) * coeff, 1)
