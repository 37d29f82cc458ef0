"""Joint-space trajectory terms (position / velocity and the other finite
difference orders), each as cost (squared or hinge-band) or constraint
(eq or ineq-band), on batched trajectories.

Counterpart of ``trajopt_tpu/terms/joint.py`` (the reference's
Joint{Pos,Vel,Acc,Jerk}{Eq,Ineq}{Cost,Constraint}).  ``targets`` /
``coeffs`` / tolerances accept a concrete vector or a params-dict key
resolved per lane at solve time (``params[key]`` is ``[B, n_dof]``).
"""

from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.sqp.nlp import Consts, Kind, TermSet, as_like

_STENCILS = {
    "pos": (np.array([1.0]), 0),
    "vel": (np.array([-1.0, 1.0]), 1),
    "acc": (np.array([1.0, -2.0, 1.0]), 2),
    "jerk": (np.array([-1.0, 3.0, -3.0, 1.0]), 3),
}


def _resolve(spec, params, n_dof, like, default, owner):
    """[n_dof] constant (kept on ``owner``) or [B, n_dof] per-lane value
    (a params key)."""
    if spec is None:
        spec = default
    v = params[spec] if isinstance(spec, str) else spec
    v = as_like(v, like, owner)
    return v if v.dim() == 2 else torch.broadcast_to(v, (n_dof,))


def _fix_range(first: int, last: int, n_steps: int, span: int):
    """Clamp/expand the step range the way the reference's hatch does."""
    if last <= -1:
        last = n_steps - 1
    if first > n_steps - 1 - span:
        first = n_steps - 1 - span
    if last > n_steps - 1:
        last = n_steps - 1
    if last - first < span:
        last = first + span
    if last < first:
        first, last = last, first
    if first < 0 or last > n_steps - 1:
        raise ValueError(
            f"joint term range [{first}, {last}] needs span {span} within "
            f"{n_steps} steps")
    return first, last


def _deriv_rows(x, n_steps, n_dof_total, n_dof, deriv, first, last):
    """[B, n_t, n_dof] finite-difference values of the given order."""
    stencil, span = _STENCILS[deriv]
    q = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
    n_t = last - first + 1 - span
    out = x.new_zeros(x.shape[0], n_t, n_dof)
    for k, s in enumerate(stencil):
        out = out + s * q[:, first + k: first + k + n_t]
    return out


def _has_band(tols) -> bool:
    if tols is None:
        return False
    if isinstance(tols, str):
        return True
    return bool(np.any(np.asarray(tols) != 0.0))


def joint_term(deriv: str, is_cost: bool, n_steps: int, n_dof: int, *,
               targets=None, coeffs=None, upper_tols=None, lower_tols=None,
               first_step: int = 0, last_step: int = -1,
               n_dof_total: int | None = None,
               name: str | None = None) -> TermSet:
    """Build the TermSet for one Joint{Pos,Vel,Acc,Jerk}TermInfo.hatch()."""
    if deriv not in _STENCILS:
        raise ValueError(f"unknown joint derivative {deriv!r}")
    stencil, span = _STENCILS[deriv]
    n_dof_total = n_dof_total or n_dof
    first, last = _fix_range(first_step, last_step, n_steps, span)
    n_t = last - first + 1 - span
    name = name or f"joint_{deriv}"
    has_tols = _has_band(upper_tols) or _has_band(lower_tols)
    band_width = (span + 1) * n_dof_total
    base_starts = np.repeat(np.arange(first, first + n_t) * n_dof_total,
                            n_dof)
    j_idx = np.tile(np.arange(n_dof), n_t)
    # the band columns of each stencil tap k, one row a (step, dof)
    taps = Consts(rows=np.arange(n_t * n_dof),
                  cols=np.stack([k * n_dof_total + j_idx
                                 for k in range(len(stencil))]))

    def coeff(params, like):
        return _resolve(coeffs, params, n_dof, like, np.ones(n_dof), taps)

    def banded(c, x):
        """[B, n_t * n_dof, band_width] windows with per-dof coeffs."""
        W = x.new_zeros(x.shape[0], n_t * n_dof, band_width)
        ct = torch.tile(c, (n_t,))
        rows, cols = taps.get("rows", x), taps.get("cols", x)
        for k, sv in enumerate(stencil):
            W[:, rows, cols[k]] = sv * ct
        return W

    def values(x, params):
        v = _deriv_rows(x, n_steps, n_dof_total, n_dof, deriv, first, last)
        t = _resolve(targets, params, n_dof, x, np.zeros(n_dof), taps)
        return v - t[..., None, :]

    if not has_tols:
        if is_cost:
            def fn(x, params):
                return values(x, params).reshape(x.shape[0], -1)

            def weight_fn(params):
                c = coeffs if coeffs is not None else np.ones(n_dof)
                if isinstance(c, str):
                    return torch.tile(params[c], (n_t,))
                return np.tile(np.broadcast_to(np.asarray(c, float),
                                               (n_dof,)), n_t)

            return TermSet(name, Kind.COST_SQ, fn, n_t * n_dof,
                           weight_fn=weight_fn, linear=True,
                           jac_band=(base_starts, band_width))

        def fn(x, params):
            return (values(x, params) * coeff(params, x)[..., None, :]
                    ).reshape(x.shape[0], -1)

        return TermSet(name, Kind.CNT_EQ, fn, n_t * n_dof, linear=True,
                       banded_jac=lambda x, p: banded(coeff(p, x), x),
                       band_starts=base_starts, band_width=band_width)

    def fn(x, params):
        diff = values(x, params)
        c = coeff(params, x)[..., None, :]
        up = _resolve(upper_tols, params, n_dof, x, np.zeros(n_dof), taps)
        lo = _resolve(lower_tols, params, n_dof, x, np.zeros(n_dof), taps)
        upper_rows = (diff - up[..., None, :]) * c
        lower_rows = (lo[..., None, :] - diff) * c
        B = x.shape[0]
        return torch.cat([upper_rows.reshape(B, -1),
                          lower_rows.reshape(B, -1)], -1)

    def banded_band(x, params):
        up = banded(coeff(params, x), x)
        return torch.cat([up, -up], 1)

    kind = Kind.COST_HINGE if is_cost else Kind.CNT_INEQ
    return TermSet(name, kind, fn, 2 * n_t * n_dof, linear=True,
                   banded_jac=banded_band,
                   band_starts=np.concatenate([base_starts, base_starts]),
                   band_width=band_width)


def joint_pos(n_steps, n_dof, is_cost=True, **kw) -> TermSet:
    return joint_term("pos", is_cost, n_steps, n_dof, **kw)


def joint_vel(n_steps, n_dof, is_cost=True, **kw) -> TermSet:
    return joint_term("vel", is_cost, n_steps, n_dof, **kw)


def joint_acc(n_steps, n_dof, is_cost=True, **kw) -> TermSet:
    return joint_term("acc", is_cost, n_steps, n_dof, **kw)


def joint_jerk(n_steps, n_dof, is_cost=True, **kw) -> TermSet:
    return joint_term("jerk", is_cost, n_steps, n_dof, **kw)
