"""Collision terms over a CollisionScene: the discrete and cast (swept)
evaluators.

Counterpart of ``trajopt_tpu/terms/collision.py`` (the reference's
``collision_terms.cpp``): residual ``coeff * (margin - distance)`` as a
hinge cost or an inequality constraint, fixed steps excluded.

* ``discrete``: one row per (step, pair) at the step's configuration, the
  worst ``max_num_cnt`` rows kept per step, one merit group per step.
* ``cast``: one row per (gap, LVS sub-segment, pair) of the swept check,
  the worst ``max_num_cnt`` rows kept per (gap, sub-segment), one merit
  group per gap.

Both give the residual rows, the dense Jacobian (``jac_fn`` /
``val_jac_fn``, for the dense QP path) and the banded one
(``banded_jac`` / ``val_banded_jac``, for the block QP path), with
per-pair coefficient/margin overrides.  The ``lvs_discrete`` evaluator and
the ``weighted_average`` aggregation wait for a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.sqp.nlp import Kind, TermSet

EVALUATORS = ("discrete", "cast")


def _per_pair(scene: CollisionScene, value, overrides) -> np.ndarray:
    """Broadcast a scalar/array to per-pair values with per-link/geom-pair
    overrides keyed by (name_a, name_b) or (link_a, link_b)."""
    pairs = scene.pairs()
    out = np.broadcast_to(np.asarray(value, float), (len(pairs),)).copy()
    if overrides:
        for i, (ga, gb) in enumerate(pairs):
            for key, v in overrides.items():
                ka, kb = key
                names = {ga.name, gb.name, ga.link, gb.link}
                if ka in names and kb in names:
                    out[i] = v
    return out


def _step_pair_matrix(scene: CollisionScene, value, overrides,
                      n_steps: int) -> np.ndarray:
    """[n_steps, n_pairs] coeff/margin data (scalar or per-step vector,
    with per-pair overrides)."""
    arr = np.asarray(value, float).reshape(-1)
    if arr.size == 1:
        step_vals = np.full(n_steps, arr[0])
    elif arr.size == n_steps:
        step_vals = arr
    else:
        raise ValueError(
            f"collision coeff/margin must be a scalar or length-{n_steps} "
            f"per-timestep vector, got length {arr.size}")
    M = np.tile(step_vals[:, None], (1, scene.n_pairs))
    if overrides:
        ov = _per_pair(scene, np.nan, overrides)
        mask = ~np.isnan(ov)
        M[:, mask] = ov[mask]
    return M


def top_k(v: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending values, the lower
    index first among equal values (a stable sort)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _Consts:
    """numpy constants of a term as tensors, cached per device/dtype."""

    def __init__(self, **arrays):
        self._np = arrays
        self._cache = {}

    def get(self, name, like: torch.Tensor):
        key = (name, like.device, like.dtype)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._np[name], dtype=like.dtype,
                                               device=like.device)
        return self._cache[key]


def collision_term(scene: CollisionScene, n_steps: int, *, margin,
                   coeff=20.0, is_cost: bool = True,
                   evaluator: str = "discrete", first_step: int = 0,
                   last_step: int = -1, fixed_steps: Sequence[int] = (),
                   lvs_substeps: int = 5, pair_coeffs: dict | None = None,
                   pair_margins: dict | None = None,
                   max_num_cnt: int | None = None,
                   n_dof_total: int | None = None,
                   name: str | None = None) -> TermSet:
    """Build the collision TermSet (CollisionTermInfo::hatch)."""
    if evaluator not in EVALUATORS:
        raise ValueError(f"evaluator must be one of {EVALUATORS} (the "
                         f"lvs_discrete evaluator is not ported yet)")
    n_dof_total = n_dof_total or scene.tree.n_dof
    if last_step <= -1:
        last_step = n_steps - 1
    n_pairs = scene.n_pairs
    if n_pairs == 0:
        raise ValueError("collision scene has no candidate pairs")
    name = name or f"collision_{evaluator}"
    coeff_mat = _step_pair_matrix(scene, coeff, pair_coeffs, n_steps)
    margin_mat = _step_pair_matrix(scene, margin, pair_margins, n_steps)
    topk = max_num_cnt is not None and max_num_cnt < n_pairs
    k_rows = max_num_cnt if topk else n_pairs
    kind = Kind.COST_HINGE if is_cost else Kind.CNT_INEQ
    common = (scene, n_steps, n_dof_total, coeff_mat, margin_mat, topk,
              k_rows, first_step, last_step, fixed_steps)
    if evaluator == "discrete":
        return _discrete_term(name, kind, *common)
    return _cast_term(name, kind, *common, lvs_substeps)


def _discrete_term(name, kind, scene, n_steps, n_dof_total, coeff_mat,
                   margin_mat, topk, k_rows, first_step, last_step,
                   fixed_steps) -> TermSet:
    """One row per (step, pair) at the step's configuration; rows stay
    inside their step, so the Jacobian is banded (one step's columns)."""
    tree = scene.tree
    n_dof = tree.n_dof
    steps = np.asarray([t for t in range(first_step, last_step + 1)
                        if t not in fixed_steps])
    S = len(steps)
    onehot = np.zeros((S, n_steps))
    onehot[np.arange(S), steps] = 1.0
    consts = _Consts(coeff=coeff_mat[steps], margin=margin_mat[steps],
                     onehot=onehot)                       # [S, P], [S, T]
    steps_t = {}

    def _qs(x):
        if x.device not in steps_t:
            steps_t[x.device] = torch.as_tensor(steps, device=x.device)
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        return qs[:, steps_t[x.device]]                   # [B, S, n_dof]

    def _viol(ds, like):
        return consts.get("coeff", like) * (consts.get("margin", like) - ds)

    def raw(x, params):
        """Exact residual rows [B, S * k]."""
        rows = _viol(scene.distances(tree.fk(_qs(x))), x)
        if topk:
            rows, _ = top_k(rows, k_rows)
        return rows.reshape(x.shape[0], -1)

    def _select(x):
        """(rows [B, S, k], Jacobian blocks [B, S, k, n_dof]) from one
        narrowphase pass, after the within-step top-k."""
        ds, Js = scene.distances_and_jac(tree.fk_with_axes(_qs(x)))
        Js = -Js * consts.get("coeff", x)[..., None]
        viol = _viol(ds, x)
        if topk:
            viol, idx = top_k(viol, k_rows)
            Js = torch.gather(Js, -2, idx[..., None].expand(*idx.shape,
                                                            n_dof))
        return viol, Js

    def _dense(Js):
        """Blocks scattered into the dense Jacobian [B, S * k, n]."""
        B, k = Js.shape[0], Js.shape[2]
        J = torch.einsum("bspd,st->bsptd", Js, consts.get("onehot", Js))
        if n_dof_total > n_dof:
            J = torch.cat([J, J.new_zeros(*J.shape[:-1],
                                          n_dof_total - n_dof)], -1)
        return J.reshape(B, S * k, n_steps * n_dof_total)

    def _banded(Js):
        B = Js.shape[0]
        W = Js.new_zeros(B, S * k_rows, n_dof_total)
        W[..., :n_dof] = Js.reshape(B, S * k_rows, n_dof)
        return W

    def val_jac(x, params):
        viol, Js = _select(x)
        return viol.reshape(x.shape[0], -1), _dense(Js)

    def val_banded_jac(x, params):
        viol, Js = _select(x)
        return viol.reshape(x.shape[0], -1), _banded(Js)

    is_cost = kind is Kind.COST_HINGE
    return TermSet(
        name, kind, raw, S * k_rows,
        jac_fn=lambda x, p: _dense(_select(x)[1]), val_jac_fn=val_jac,
        banded_jac=lambda x, p: _banded(_select(x)[1]),
        band_starts=np.repeat(steps * n_dof_total, k_rows),
        band_width=n_dof_total, val_banded_jac=val_banded_jac,
        groups=None if is_cost else np.repeat(np.arange(S), k_rows),
        n_groups=1 if is_cost else S)


def _cast_term(name, kind, scene, n_steps, n_dof_total, coeff_mat,
               margin_mat, topk, k_rows, first_step, last_step, fixed_steps,
               lvs_substeps) -> TermSet:
    """One row per (gap, LVS sub-segment, pair) of the swept check."""
    tree = scene.tree
    n_dof = tree.n_dof
    # A gap is skipped only when BOTH endpoints are fixed.
    gaps = np.asarray([t for t in range(first_step, last_step)
                       if not (t in fixed_steps and (t + 1) in fixed_steps)])
    G = len(gaps)
    n_sub = lvs_substeps
    fracs = np.linspace(0.0, 1.0, lvs_substeps + 1)
    consts = _Consts(coeff=coeff_mat[gaps][:, None, :],      # [G, 1, P]
                     margin=margin_mat[gaps][:, None, :],
                     fr_all=fracs, fr_a=fracs[:-1], fr_b=fracs[1:])
    gaps_t = {}

    def _endpoints(x):
        if x.device not in gaps_t:
            gaps_t[x.device] = torch.as_tensor(gaps, device=x.device)
        g = gaps_t[x.device]
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        return qs[:, g], qs[:, g + 1]                     # [B, G, n_dof]

    def _interp(x):
        a, b = _endpoints(x)
        dq = b - a
        fr = consts.get("fr_all", x)
        return a[..., None, :] + fr[:, None] * dq[..., None, :]

    def _viol(ds, like):
        return consts.get("coeff", like) * (consts.get("margin", like) - ds)

    def raw(x, params):
        """Exact residual rows [B, G * n_sub * k]."""
        R, p = tree.fk(_interp(x))                  # [B, G, n_sub+1, L, ...]
        ds = scene.swept_distances((R[:, :, :-1], p[:, :, :-1]),
                                   (R[:, :, 1:], p[:, :, 1:]))
        rows = _viol(ds, x)
        if topk:
            rows, _ = top_k(rows, k_rows)
        return rows.reshape(x.shape[0], -1)

    def val_banded_jac(x, params):
        """(rows [B, m], W [B, m, 2 * n_dof_total]): one swept pass with
        endpoint FK shared across sub-segments, Jacobians chained through
        the interpolation q_f = (1 - f) q0 + f q1."""
        R, p, z, o = tree.fk_with_axes(_interp(x))
        ds, Ja, Jb = scene.swept_distances_and_jac(
            (R[:, :, :-1], p[:, :, :-1], z[:, :, :-1], o[:, :, :-1]),
            (R[:, :, 1:], p[:, :, 1:], z[:, :, 1:], o[:, :, 1:]))
        fa = consts.get("fr_a", x)[:, None, None]
        fb = consts.get("fr_b", x)[:, None, None]
        cf = consts.get("coeff", x)[..., None]
        J0 = -((1.0 - fa) * Ja + (1.0 - fb) * Jb) * cf
        J1 = -(fa * Ja + fb * Jb) * cf
        viol = _viol(ds, x)                            # [B, G, n_sub, P]
        if topk:
            viol, idx = top_k(viol, k_rows)
            take = idx[..., None].expand(*idx.shape, n_dof)
            J0 = torch.gather(J0, -2, take)
            J1 = torch.gather(J1, -2, take)
        B = x.shape[0]
        m_rows = G * n_sub * k_rows
        W = x.new_zeros(B, m_rows, 2 * n_dof_total)
        W[..., :n_dof] = J0.reshape(B, m_rows, n_dof)
        W[..., n_dof_total:n_dof_total + n_dof] = J1.reshape(B, m_rows, n_dof)
        return viol.reshape(B, -1), W

    is_cost = kind is Kind.COST_HINGE
    return TermSet(
        name, kind, raw, G * n_sub * k_rows,
        banded_jac=lambda x, p: val_banded_jac(x, p)[1],
        band_starts=np.repeat(gaps * n_dof_total, n_sub * k_rows),
        band_width=2 * n_dof_total, val_banded_jac=val_banded_jac,
        groups=None if is_cost else np.repeat(np.arange(G), n_sub * k_rows),
        n_groups=1 if is_cost else G)
