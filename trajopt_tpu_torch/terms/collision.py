"""Collision terms over a CollisionScene: the discrete, LVS-discrete and
cast (swept) evaluators.

Counterpart of ``trajopt_tpu/terms/collision.py`` (the reference's
``collision_terms.cpp``): residual ``coeff * (margin - distance)`` as a
hinge cost or an inequality constraint, fixed steps excluded.

* ``discrete``: one row per (step, pair) at the step's configuration, the
  worst ``max_num_cnt`` rows kept per step, one merit group per step.
* ``lvs_discrete``: one row per (gap, sub-point, pair) at the
  ``lvs_substeps + 1`` interpolated configurations of each gap (both ends
  included, so adjacent gaps repeat their shared end's rows), the worst
  ``max_num_cnt`` rows kept per (gap, sub-point), one merit group per gap.
* ``cast``: one row per (gap, LVS sub-segment, pair) of the swept check,
  the worst ``max_num_cnt`` rows kept per (gap, sub-segment), one merit
  group per gap.

``aggregate="weighted_average"`` (every evaluator) turns the pair axis
into link pairs, as the ifopt stack does: a link pair's row is the largest
error of its geometry pairs and its Jacobian their average weighted by the
buffered errors ``max(0, coeff * (margin + safety_margin_buffer - d))``;
``max_num_cnt`` then caps link-pair rows.

Each gives the residual rows, the dense Jacobian (``jac_fn`` /
``val_jac_fn``, for the dense QP path) and the banded one (``banded_jac`` /
``val_banded_jac``, for the block QP path), both from the narrowphase's
analytic Jacobians, with per-pair coefficient/margin overrides: no solver
path differentiates through the narrowphase (on the card its kernel
returns values and Jacobians, not an autograd graph).  The LVS
evaluator queries every lane, gap and sub-point in one narrowphase call.
Every narrowphase call gets the solve's ``params`` (the centers of world
geometry registered with ``center_param``), as the JAX term's do.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.sqp.nlp import Consts, Kind, TermSet, banded_to_dense

EVALUATORS = ("discrete", "lvs_discrete", "cast")
AGGREGATES = ("none", "weighted_average")


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


def _link_pair_partition(scene: CollisionScene):
    """Static partition of the candidate geometry pairs by link pair (the
    unit the ifopt stack aggregates over): (index [P], count)."""
    lp_of: dict = {}
    pairs = scene.pairs()
    lp_index = np.zeros(len(pairs), np.int64)
    for i, (ga, gb) in enumerate(pairs):
        key = tuple(sorted((ga.link or ga.name, gb.link or gb.name)))
        lp_index[i] = lp_of.setdefault(key, len(lp_of))
    return lp_index, len(lp_of)


class _Rows:
    """The rows kept of one step's (or sub-point's) pair axis: the
    optional weighted-average aggregation over link pairs, then the
    optional top-k."""

    def __init__(self, scene: CollisionScene, aggregate: str,
                 safety_margin_buffer: float, max_num_cnt: int | None):
        self.wavg = aggregate == "weighted_average"
        n_units = scene.n_pairs
        if self.wavg:
            lp_index, n_units = _link_pair_partition(scene)
            self.consts = Consts(lp=lp_index)
        self.n_lp = n_units
        self.buf = float(safety_margin_buffer)
        self.topk = max_num_cnt is not None and max_num_cnt < n_units
        self.k = max_num_cnt if self.topk else n_units

    def _seg_max(self, v):
        lp = self.consts.get("lp", v)
        out = v.new_full((*v.shape[:-1], self.n_lp), -float("inf"))
        return out.scatter_reduce(-1, lp.expand(v.shape), v, "amax")

    def _seg_sum(self, v, dim):
        shape = list(v.shape)
        shape[dim] = self.n_lp
        return v.new_zeros(shape).index_add(dim, self.consts.get("lp", v), v)

    def values(self, viol):
        """[..., P] errors -> [..., k] rows."""
        if self.wavg:
            viol = self._seg_max(viol)
        if self.topk:
            viol, _ = top_k(viol, self.k)
        return viol

    def select(self, viol, coeff, *jacs):
        """(rows [..., k], each Jacobian [..., P, n_dof] -> [..., k,
        n_dof]): member Jacobians averaged with the buffered errors as
        weights, then the rows and Jacobians of the top k."""
        if self.wavg:
            w = torch.clamp_min(viol + coeff * self.buf, 0.0)
            tot = self._seg_sum(w, -1)
            has = (tot > 0.0)[..., None]
            safe = torch.where(tot > 0.0, tot, torch.ones_like(tot))
            jacs = [torch.where(has, self._seg_sum(w[..., None] * J, -2)
                                / safe[..., None], torch.zeros((), dtype=J.dtype,
                                                               device=J.device))
                    for J in jacs]
            viol = self._seg_max(viol)
        if self.topk:
            viol, idx = top_k(viol, self.k)
            take = idx[..., None].expand(*idx.shape, jacs[0].shape[-1])
            jacs = [torch.gather(J, -2, take) for J in jacs]
        return viol, jacs


def collision_term(scene: CollisionScene, n_steps: int, *, margin,
                   coeff=20.0, is_cost: bool = True,
                   evaluator: str = "discrete", first_step: int = 0,
                   last_step: int = -1, fixed_steps: Sequence[int] = (),
                   lvs_substeps: int = 5, pair_coeffs: dict | None = None,
                   pair_margins: dict | None = None,
                   max_num_cnt: int | None = None, aggregate: str = "none",
                   safety_margin_buffer: float = 0.0,
                   n_dof_total: int | None = None,
                   name: str | None = None) -> TermSet:
    """Build the collision TermSet (CollisionTermInfo::hatch)."""
    if evaluator not in EVALUATORS:
        raise ValueError(f"evaluator must be one of {EVALUATORS}")
    if aggregate not in AGGREGATES:
        raise ValueError(f"aggregate must be one of {AGGREGATES}")
    n_dof_total = n_dof_total or scene.tree.n_dof
    if last_step <= -1:
        last_step = n_steps - 1
    if scene.n_pairs == 0:
        raise ValueError("collision scene has no candidate pairs")
    name = name or f"collision_{evaluator}"
    coeff_mat = _step_pair_matrix(scene, coeff, pair_coeffs, n_steps)
    margin_mat = _step_pair_matrix(scene, margin, pair_margins, n_steps)
    sel = _Rows(scene, aggregate, safety_margin_buffer, max_num_cnt)
    kind = Kind.COST_HINGE if is_cost else Kind.CNT_INEQ
    common = (scene, n_steps, n_dof_total, coeff_mat, margin_mat, sel,
              first_step, last_step, fixed_steps)
    if evaluator == "discrete":
        return _discrete_term(name, kind, *common)
    if evaluator == "lvs_discrete":
        return _lvs_term(name, kind, *common, lvs_substeps)
    return _cast_term(name, kind, *common, lvs_substeps)


def _discrete_term(name, kind, scene, n_steps, n_dof_total, coeff_mat,
                   margin_mat, sel, first_step, last_step,
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
    consts = Consts(coeff=coeff_mat[steps], margin=margin_mat[steps],
                     onehot=onehot)                       # [S, P], [S, T]
    steps_t = {}

    def _qs(x):
        if x.device not in steps_t:
            steps_t[x.device] = torch.as_tensor(steps, device=x.device)
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        return qs[:, steps_t[x.device]]                   # [B, S, n_dof]

    def _viol(ds, like):
        return consts.get("coeff", like) * (consts.get("margin", like) - ds)

    k_rows = sel.k

    def raw(x, params):
        """Exact residual rows [B, S * k]."""
        rows = sel.values(_viol(scene.distances(tree.fk(_qs(x)), params),
                                x))
        return rows.reshape(x.shape[0], -1)

    def _select(x, params):
        """(rows [B, S, k], Jacobian blocks [B, S, k, n_dof]) from one
        narrowphase pass, after the within-step selection."""
        ds, Js = scene.distances_and_jac(tree.fk_with_axes(_qs(x)), params)
        cf = consts.get("coeff", x)
        viol, (Js,) = sel.select(_viol(ds, x), cf, -Js * cf[..., None])
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
        viol, Js = _select(x, params)
        return viol.reshape(x.shape[0], -1), _dense(Js)

    def val_banded_jac(x, params):
        viol, Js = _select(x, params)
        return viol.reshape(x.shape[0], -1), _banded(Js)

    is_cost = kind is Kind.COST_HINGE
    return TermSet(
        name, kind, raw, S * k_rows,
        jac_fn=lambda x, p: _dense(_select(x, p)[1]), val_jac_fn=val_jac,
        banded_jac=lambda x, p: _banded(_select(x, p)[1]),
        band_starts=np.repeat(steps * n_dof_total, k_rows),
        band_width=n_dof_total, val_banded_jac=val_banded_jac,
        groups=None if is_cost else np.repeat(np.arange(S), k_rows),
        n_groups=1 if is_cost else S)


def _lvs_term(name, kind, *common) -> TermSet:
    return _gap_term(name, kind, *common, swept=False)


def _cast_term(name, kind, *common) -> TermSet:
    return _gap_term(name, kind, *common, swept=True)


def _gap_term(name, kind, scene, n_steps, n_dof_total, coeff_mat, margin_mat,
              sel, first_step, last_step, fixed_steps, lvs_substeps, *,
              swept: bool) -> TermSet:
    """One row per (gap, sub-query, pair): the swept check of each of a
    gap's ``lvs_substeps`` sub-segments (``swept``), or the discrete check
    at its ``lvs_substeps + 1`` interpolated configurations, ends included.
    Rows couple the gap's two steps, so the Jacobian is banded (two steps'
    columns)."""
    tree = scene.tree
    n_dof = tree.n_dof
    # A gap is skipped only when BOTH endpoints are fixed.
    gaps = np.asarray([t for t in range(first_step, last_step)
                       if not (t in fixed_steps and (t + 1) in fixed_steps)],
                      np.int64)
    G = len(gaps)
    n_sub = lvs_substeps if swept else lvs_substeps + 1
    fracs = np.linspace(0.0, 1.0, lvs_substeps + 1)
    consts = Consts(coeff=coeff_mat[gaps][:, None, :],      # [G, 1, P]
                    margin=margin_mat[gaps][:, None, :],
                    fr_all=fracs, fr_a=fracs[:-1], fr_b=fracs[1:], gaps=gaps)
    k_rows = sel.k
    m_rows = G * n_sub * k_rows
    band_starts = np.repeat(gaps * n_dof_total, n_sub * k_rows)

    def _interp(x):
        """[B, G, lvs_substeps + 1, n_dof]: q0 + f (q1 - q0) per gap."""
        g = consts.get("gaps", x)
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        a, b = qs[:, g], qs[:, g + 1]                     # [B, G, n_dof]
        fr = consts.get("fr_all", x)
        return a[..., None, :] + fr[:, None] * (b - a)[..., None, :]

    def _viol(ds, like):
        return consts.get("coeff", like) * (consts.get("margin", like) - ds)

    def raw(x, params):
        """Exact residual rows [B, G * n_sub * k]."""
        if swept:
            R, p = tree.fk(_interp(x))              # [B, G, n_sub+1, L, ...]
            ds = scene.swept_distances((R[:, :, :-1], p[:, :, :-1]),
                                       (R[:, :, 1:], p[:, :, 1:]), params)
        else:
            ds = scene.distances(tree.fk(_interp(x)), params)
        return sel.values(_viol(ds, x)).reshape(x.shape[0], -1)

    def val_banded_jac(x, params):
        """(rows [B, m], W [B, m, 2 * n_dof_total]): one narrowphase pass
        over all lanes, gaps and sub-queries (swept: endpoint FK shared
        across sub-segments), Jacobians chained through the interpolation
        q_f = (1 - f) q0 + f q1."""
        R, p, z, o = tree.fk_with_axes(_interp(x))
        if swept:
            ds, Ja, Jb = scene.swept_distances_and_jac(
                (R[:, :, :-1], p[:, :, :-1], z[:, :, :-1], o[:, :, :-1]),
                (R[:, :, 1:], p[:, :, 1:], z[:, :, 1:], o[:, :, 1:]),
                params)
            fa = consts.get("fr_a", x)[:, None, None]
            fb = consts.get("fr_b", x)[:, None, None]
            J0 = (1.0 - fa) * Ja + (1.0 - fb) * Jb
            J1 = fa * Ja + fb * Jb
        else:
            ds, J = scene.distances_and_jac((R, p, z, o), params)
            f = consts.get("fr_all", x)[:, None, None]
            J0, J1 = (1.0 - f) * J, f * J
        cf = consts.get("coeff", x)
        viol, (J0, J1) = sel.select(_viol(ds, x), cf, -J0 * cf[..., None],
                                    -J1 * cf[..., None])
        B = x.shape[0]
        W = x.new_zeros(B, m_rows, 2 * n_dof_total)
        W[..., :n_dof] = J0.reshape(B, m_rows, n_dof)
        W[..., n_dof_total:n_dof_total + n_dof] = J1.reshape(B, m_rows, n_dof)
        return viol.reshape(B, -1), W

    def val_jac(x, params):
        r, W = val_banded_jac(x, params)
        return r, banded_to_dense(W, band_starts, n_steps * n_dof_total)

    is_cost = kind is Kind.COST_HINGE
    return TermSet(
        name, kind, raw, m_rows,
        jac_fn=lambda x, p: val_jac(x, p)[1], val_jac_fn=val_jac,
        banded_jac=lambda x, p: val_banded_jac(x, p)[1],
        band_starts=band_starts, band_width=2 * n_dof_total,
        val_banded_jac=val_banded_jac,
        groups=None if is_cost else np.repeat(np.arange(G), n_sub * k_rows),
        n_groups=1 if is_cost else G)
