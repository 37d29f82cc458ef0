"""Nonconvex problem model: term sets, structured convexification, exact
evaluation, on batched tensors.

Counterpart of ``trajopt_tpu/sqp/nlp.py`` (the reference's ``sco::Cost`` /
``sco::Constraint`` layer).  A term is a function ``fn(x, params) ->
residuals`` on a batch: ``x [B, n]``, ``params`` a dict of tensors with a
leading ``B`` axis, residuals ``[B, n_rows]``.  Jacobians of affine terms
come from ``torch.func.jacrev``; collision terms supply analytic banded
Jacobians.

Generic scalar costs (``COST_GENERIC_FULL`` / ``COST_GENERIC_DIAG``) take
a PSD-projected second-order Taylor model: the full Hessian from
``torch.func.hessian`` with its negative eigenvalues clamped
(``_psd_project``, ``torch.linalg.eigh``), or the clamped diagonal of
second directional derivatives.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from trajopt_tpu_torch.utils import device_const, on_device

Params = dict


class Kind(enum.Enum):
    """Term classification (the reference's PenaltyType / ConstraintType)."""

    COST_SQ = "cost_sq"
    COST_ABS = "cost_abs"
    COST_HINGE = "cost_hinge"
    COST_GENERIC_FULL = "cost_generic_full"
    COST_GENERIC_DIAG = "cost_generic_diag"
    CNT_EQ = "cnt_eq"
    CNT_INEQ = "cnt_ineq"


COST_KINDS = (Kind.COST_SQ, Kind.COST_ABS, Kind.COST_HINGE,
              Kind.COST_GENERIC_FULL, Kind.COST_GENERIC_DIAG)
CNT_KINDS = (Kind.CNT_EQ, Kind.CNT_INEQ)
PENALTY_COST_KINDS = (Kind.COST_ABS, Kind.COST_HINGE)
GENERIC_KINDS = (Kind.COST_GENERIC_FULL, Kind.COST_GENERIC_DIAG)


def one_lane(params: dict) -> dict:
    """A single lane's params (as ``torch.func.vmap`` hands them over)
    with the lane axis put back: every tensor leaf ``v -> v[None]``."""
    return {k: tuple(e[None] for e in v) if isinstance(v, tuple)
            else v[None] for k, v in params.items()}


def as_like(v, like: torch.Tensor, owner) -> torch.Tensor:
    """``v`` as a tensor on ``like``'s device and dtype.  A host array is
    uploaded once per content and kept on ``owner`` (the term or set whose
    value it is; :func:`~trajopt_tpu_torch.utils.on_device`), a number
    through :func:`~trajopt_tpu_torch.utils.device_const`: a captured
    region cannot copy from the host."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    a = np.asarray(v)
    if a.ndim == 0:
        return device_const(a, like.device, like.dtype)
    return on_device(owner, ("value", a.dtype.str, a.shape, a.tobytes()),
                     lambda: a, like.device, like.dtype)


class Consts:
    """A term's numpy constants as tensors on ``like``'s device, cached per
    device and dtype: floating arrays in ``like``'s dtype, integer and
    boolean arrays (indices, masks) in their own."""

    def __init__(self, **arrays):
        self._np = {k: np.array(v) for k, v in arrays.items()}
        self._cache = {}

    def get(self, name, like: torch.Tensor):
        key = (name, like.device, like.dtype)
        if key not in self._cache:
            a = self._np[name]
            self._cache[key] = torch.as_tensor(
                a, dtype=like.dtype if a.dtype.kind == "f" else None,
                device=like.device)
        return self._cache[key]


@dataclasses.dataclass(frozen=True)
class TermSet:
    """One named group of residual rows sharing a kind.

    ``fn(x [B, n], params) -> [B, n_rows]``; ``weight_fn(params)`` gives
    per-row cost weights (scalar, ``[n_rows]`` or ``[B, n_rows]``).
    ``banded_jac(x, params) -> W [B, n_rows, band_width]`` with row r
    covering columns ``band_starts[r] ... + band_width``;
    ``val_banded_jac`` returns (residuals, W) from one pass.  ``groups``
    maps constraint rows to merit units (None -> one unit).  ``jac_band =
    (starts, width)`` states the columns each row's Jacobian covers for a
    squared cost (whose Jacobian is dense): the block QP's Newton-Schulz
    refresh reads M's band from it (:func:`block_half_band`).
    ``user_code`` marks a set whose callables, though the port's own, call
    a user's function (see :func:`runs_user_code`).
    """

    name: str
    kind: Kind
    fn: Callable[[torch.Tensor, Params], torch.Tensor]
    n_rows: int
    weight_fn: Callable[[Params], Any] = lambda p: 1.0
    jac_fn: Callable | None = None
    linear: bool = False
    banded_jac: Callable | None = None
    band_starts: np.ndarray | None = None
    band_width: int = 0
    val_jac_fn: Callable | None = None
    val_banded_jac: Callable | None = None
    groups: np.ndarray | None = None
    n_groups: int = 1
    user_code: bool = False
    jac_band: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Nlp:
    """A nonconvex problem over a flat decision vector of size ``n``;
    ``block = (T, D)`` marks the trajectory layout the block QP needs."""

    n: int
    term_sets: tuple[TermSet, ...]
    block: tuple[int, int] | None = None

    @property
    def cost_sets(self) -> tuple[TermSet, ...]:
        return tuple(t for t in self.term_sets if t.kind in COST_KINDS)

    @property
    def cnt_sets(self) -> tuple[TermSet, ...]:
        return tuple(t for t in self.term_sets if t.kind in CNT_KINDS)

    @property
    def num_cost_sets(self) -> int:
        return len(self.cost_sets)

    @property
    def num_cnt_sets(self) -> int:
        return len(self.cnt_sets)


def library_code(f) -> bool:
    """Whether the callable (or class) ``f`` is the port's own code (None
    counts as such)."""
    if f is None:
        return True
    mod = str(getattr(f, "__module__", ""))
    return mod == "trajopt_tpu_torch" or mod.startswith("trajopt_tpu_torch.")


def runs_user_code(nlp: Nlp) -> bool:
    """Whether evaluating ``nlp`` runs code the port did not write: a set
    marked ``user_code`` (a user's function behind the port's closure, as
    in ``terms/user.py`` and the ifopt facade) or a callable from another
    module.  The solver evaluates such an Nlp eagerly: a user's function
    may copy a host constant to the card (``t.to(x)``), which a CUDA graph
    capture cannot hold."""
    return any(t.user_code or not all(map(library_code, (
        t.fn, t.weight_fn, t.jac_fn, t.banded_jac, t.val_jac_fn,
        t.val_banded_jac))) for t in nlp.term_sets)


def banded_to_dense(W: torch.Tensor, starts, n: int) -> torch.Tensor:
    """Dense rows [B, rows, n] of banded rows ``W [B, rows, w]`` whose row
    r covers columns ``starts[r] ... + w`` (columns past n dropped)."""
    B, rows, w = W.shape

    def cols():
        return np.asarray(starts)[:, None] + np.arange(w)
    keep = on_device(starts, ("keep", w, n), lambda: cols() < n, W.device,
                     W.dtype)
    idx = on_device(starts, ("cols", w, n),
                    lambda: np.minimum(cols(), n - 1), W.device)
    return W.new_zeros(B, rows, n).scatter_add(
        -1, idx.expand(B, rows, w), W * keep)


def _weights(t: TermSet, params, like: torch.Tensor) -> torch.Tensor:
    """Per-row weights broadcast to [B, n_rows]."""
    w = as_like(t.weight_fn(params), like, t)
    return torch.broadcast_to(w, (like.shape[0], t.n_rows))


def _residual_and_jac(term: TermSet, x, params, jac_cache=None, key=None):
    """(r [B, rows], J [B, rows, n]) of one term set."""
    if jac_cache is not None and key in jac_cache:
        return term.fn(x, params), jac_cache[key]
    if term.val_jac_fn is not None:
        return term.val_jac_fn(x, params)
    if term.jac_fn is not None:
        return term.fn(x, params), term.jac_fn(x, params)
    return term.fn(x, params), _lane_jacrev(term, x, params)


def _lane_jacrev(t: TermSet, x, params):
    """Per-lane reverse-mode Jacobian [B, rows, n] of a batched term."""
    def f(v, p):
        return t.fn(v[None], one_lane(p))[0]
    return torch.func.vmap(torch.func.jacrev(f))(x, params)


def linear_jacobians(nlp: Nlp, x: torch.Tensor, params) -> dict:
    """Constant Jacobians of affine term sets (hoisted out of the SQP
    loop), evaluated at x = 0 per lane."""
    cache = {}
    x0 = torch.zeros_like(x)
    for i, t in enumerate(nlp.term_sets):
        if t.linear and t.jac_fn is None:
            cache[i] = _lane_jacrev(t, x0, params)
    return cache


def cost_row_structure(nlp: Nlp) -> list[tuple[TermSet, slice]]:
    """Static row slices of the stacked cost rows, per non-generic set."""
    out, start = [], 0
    for t in nlp.cost_sets:
        if t.kind in GENERIC_KINDS:
            continue
        out.append((t, slice(start, start + t.n_rows)))
        start += t.n_rows
    return out


def cnt_row_structure(nlp: Nlp) -> list[tuple[TermSet, slice]]:
    out, start = [], 0
    for t in nlp.cnt_sets:
        out.append((t, slice(start, start + t.n_rows)))
        start += t.n_rows
    return out


def term_groups(t: TermSet) -> int:
    return t.n_groups if t.groups is not None else 1


def num_cnt_groups(nlp: Nlp) -> int:
    """Total merit units (one per hatched constraint; per group here)."""
    return sum(term_groups(t) for t in nlp.cnt_sets)


def cnt_group_structure(nlp: Nlp) -> list[tuple[TermSet, slice, slice]]:
    """[(term, row_slice, group_slice)] over constraint sets."""
    out, row0, g0 = [], 0, 0
    for t in nlp.cnt_sets:
        ng = term_groups(t)
        out.append((t, slice(row0, row0 + t.n_rows), slice(g0, g0 + ng)))
        row0 += t.n_rows
        g0 += ng
    return out


def cnt_group_names(nlp: Nlp) -> list[str]:
    """Diagnostic name per merit unit: the set's name, suffixed by the
    group index for multi-group sets (the reference's per-step constraint
    names)."""
    names = []
    for t in nlp.cnt_sets:
        ng = term_groups(t)
        if ng == 1:
            names.append(t.name)
        else:
            names.extend(f"{t.name}[{g}]" for g in range(ng))
    return names


def term_groups_index(t: TermSet, device) -> torch.Tensor:
    """``t.groups`` (each row's merit unit) on ``device``, kept on ``t``."""
    return on_device(t, "groups", lambda: t.groups, device)


def _group_reduce(viol_rows: torch.Tensor, t: TermSet) -> torch.Tensor:
    """Sum per-row violations [B, rows] into per-group totals."""
    if t.groups is None:
        return viol_rows.sum(-1, keepdim=True)
    out = viol_rows.new_zeros(viol_rows.shape[0], t.n_groups)
    return out.index_add(1, term_groups_index(t, out.device), viol_rows)


def _psd_project(H: torch.Tensor) -> torch.Tensor:
    """Clamp negative eigenvalues of symmetric ``H [..., n, n]`` to zero
    (CostFromFunc's full-Hessian path)."""
    w, V = torch.linalg.eigh(H)
    return (V * torch.clamp_min(w, 0.0)[..., None, :]) @ V.transpose(-1, -2)


def _generic_taylor(t: TermSet, x, params):
    """(value [B], gradient [B, n], PSD Hessian [B, n, n]) of a generic
    scalar cost per lane: the full Hessian projected onto the PSD cone
    (COST_GENERIC_FULL), or the clamped diagonal of second directional
    derivatives by forward-over-forward products, with no [n, n] Hessian
    formed (COST_GENERIC_DIAG)."""
    def f(v, p):
        return t.fn(v[None], one_lane(p)).reshape(())

    func = torch.func
    val = func.vmap(f)(x, params)
    g = func.vmap(func.grad(f))(x, params)
    if t.kind is Kind.COST_GENERIC_FULL:
        return val, g, _psd_project(func.vmap(func.hessian(f))(x, params))
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)

    def d2(v, p, e):
        def df(u):
            return func.jvp(lambda w: f(w, p), (u,), (e,))[1]
        return func.jvp(df, (v,), (e,))[1]

    h = func.vmap(lambda v, p: func.vmap(lambda e: d2(v, p, e))(eye))(
        x, params)
    return val, g, torch.diag_embed(torch.clamp_min(h, 0.0))


def _convexify_costs(nlp: Nlp, x, params, jac_cache, *, pen_rows: bool):
    """Quadratize the cost sets at x -> (P [B,n,n], q [B,n], c0 [B], and
    the affine cost rows as lists of A [B,rows,n], b and w [B,rows]).
    ``pen_rows=False`` skips the abs/hinge sets (the structured path
    re-derives their rows bandedly)."""
    B, n = x.shape
    P = x.new_zeros(B, n, n)
    q = x.new_zeros(B, n)
    c0 = x.new_zeros(B)
    A_rows, b_rows, w_rows = [], [], []
    index_of = {id(t): i for i, t in enumerate(nlp.term_sets)}
    for t in nlp.cost_sets:
        if (not pen_rows) and t.kind in PENALTY_COST_KINDS:
            continue
        if t.kind in GENERIC_KINDS:
            val, g, H = _generic_taylor(t, x, params)
            w = _weights(t, params, x)[:, 0]
            Hx = (H @ x[..., None])[..., 0]
            P = P + w[:, None, None] * H
            q = q + w[:, None] * (g - Hx)
            c0 = c0 + w * (val - (g * x).sum(-1) + 0.5 * (x * Hx).sum(-1))
            continue
        r, J = _residual_and_jac(t, x, params, jac_cache, index_of[id(t)])
        b = r - (J @ x[..., None])[..., 0]
        w = _weights(t, params, x)
        A_rows.append(J)
        b_rows.append(b)
        w_rows.append(w)
        if t.kind is Kind.COST_SQ:
            JW = J * w[..., None]
            P = P + 2.0 * (J.transpose(-1, -2) @ JW)
            q = q + 2.0 * (JW.transpose(-1, -2) @ b[..., None])[..., 0]
            c0 = c0 + (w * b * b).sum(-1)
    return P, q, c0, A_rows, b_rows, w_rows


def _interval_dist(v, l, u):
    zero = v.new_zeros(())
    return torch.maximum(v - u, zero) + torch.maximum(l - v, zero)


def eval_exact_costs(nlp: Nlp, x, params) -> torch.Tensor:
    """Per-cost-set exact values [B, n_cost_sets]."""
    vals = []
    for t in nlp.cost_sets:
        r = t.fn(x, params)
        w = as_like(t.weight_fn(params), x, t)
        if t.kind is Kind.COST_SQ:
            vals.append((w * r * r).sum(-1))
        elif t.kind is Kind.COST_ABS:
            vals.append((w * torch.abs(r)).sum(-1))
        elif t.kind is Kind.COST_HINGE:
            vals.append((w * torch.maximum(r, r.new_zeros(()))).sum(-1))
        else:
            vals.append((w * r).sum(-1))
    return torch.stack(vals, -1) if vals else x.new_zeros(x.shape[0], 0)


def eval_exact_cnt_viols(nlp: Nlp, x, params) -> torch.Tensor:
    """Per-group exact violations [B, num_cnt_groups] (|g| for EQ, pos(g)
    for INEQ, summed per merit unit)."""
    vals = []
    for t in nlp.cnt_sets:
        r = t.fn(x, params)
        rows = torch.abs(r) if t.kind is Kind.CNT_EQ \
            else torch.maximum(r, r.new_zeros(()))
        vals.append(_group_reduce(rows, t))
    return torch.cat(vals, -1) if vals else x.new_zeros(x.shape[0], 0)


# ----------------------------------------------------------------------
# Dense convexification: consumed by the dense QP path.

class ConvexModel(NamedTuple):
    """Convexified problem at a linearization point, batched.

    Cost rows (squared and penalty) are affine rows ``a(x) = A_cost x +
    b_cost``; (P, q, c0) is the quadratic of the squared rows.  Constraint
    rows are ``g(x) ~ A_cnt x + b_cnt`` with interval bounds [l_cnt, u_cnt]
    (CNT_EQ -> [0, 0], CNT_INEQ -> [-inf, 0])."""

    P: torch.Tensor       # [B, n, n]
    q: torch.Tensor       # [B, n]
    c0: torch.Tensor      # [B]
    A_cost: torch.Tensor  # [B, m_cost, n] all cost rows
    b_cost: torch.Tensor  # [B, m_cost]
    w_cost: torch.Tensor  # [B, m_cost] per-row weights
    A_cnt: torch.Tensor   # [B, m_cnt, n]
    b_cnt: torch.Tensor   # [B, m_cnt]
    l_cnt: torch.Tensor   # [B, m_cnt]
    u_cnt: torch.Tensor   # [B, m_cnt]


def _cat_rows(rows, like: torch.Tensor, width: int | None = None):
    if rows:
        return torch.cat(rows, 1)
    shape = (like.shape[0], 0) if width is None else (like.shape[0], 0,
                                                      width)
    return like.new_zeros(shape)


def convexify(nlp: Nlp, x, params, jac_cache=None) -> ConvexModel:
    """Linearize/quadratize every term set at x (one convexifyCosts +
    convexifyConstraints pass of the SQP loop) with dense Jacobians."""
    n = nlp.n
    index_of = {id(t): i for i, t in enumerate(nlp.term_sets)}
    P, q, c0, A_cost, b_cost, w_cost = _convexify_costs(
        nlp, x, params, jac_cache, pen_rows=True)
    A_cnt, b_cnt, l_cnt, u_cnt = [], [], [], []
    for t in nlp.cnt_sets:
        r, J = _residual_and_jac(t, x, params, jac_cache, index_of[id(t)])
        A_cnt.append(J)
        b_cnt.append(r - (J @ x[..., None])[..., 0])
        zeros = x.new_zeros(x.shape[0], t.n_rows)
        l_cnt.append(zeros if t.kind is Kind.CNT_EQ
                     else torch.full_like(zeros, -float("inf")))
        u_cnt.append(zeros)
    return ConvexModel(
        P=P, q=q, c0=c0, A_cost=_cat_rows(A_cost, x, n),
        b_cost=_cat_rows(b_cost, x), w_cost=_cat_rows(w_cost, x),
        A_cnt=_cat_rows(A_cnt, x, n), b_cnt=_cat_rows(b_cnt, x),
        l_cnt=_cat_rows(l_cnt, x), u_cnt=_cat_rows(u_cnt, x))


def eval_model_costs(nlp: Nlp, model: ConvexModel, x) -> torch.Tensor:
    """Per-cost-set convex model values [B, n_cost_sets] at x, in cost-set
    order.  Generic sets report 0: their value lives in the shared
    quadratic (totals via :func:`model_cost_total`)."""
    a = (model.A_cost @ x[..., None])[..., 0] + model.b_cost
    rows_of = {id(t): sl for t, sl in cost_row_structure(nlp)}
    vals = []
    for t in nlp.cost_sets:
        if t.kind in GENERIC_KINDS:
            vals.append(x.new_zeros(x.shape[0]))
            continue
        sl = rows_of[id(t)]
        w, rows = model.w_cost[:, sl], a[:, sl]
        if t.kind is Kind.COST_SQ:
            vals.append((w * rows * rows).sum(-1))
        elif t.kind is Kind.COST_ABS:
            vals.append((w * torch.abs(rows)).sum(-1))
        else:  # COST_HINGE
            vals.append((w * torch.clamp_min(rows, 0.0)).sum(-1))
    return torch.stack(vals, -1) if vals else x.new_zeros(x.shape[0], 0)


def model_cost_total(nlp: Nlp, model: ConvexModel, x) -> torch.Tensor:
    """[B] total convex cost model at x: the quadratic part plus the
    abs/hinge penalty rows."""
    total = 0.5 * (x * (model.P @ x[..., None])[..., 0]).sum(-1) \
        + (model.q * x).sum(-1) + model.c0
    a = (model.A_cost @ x[..., None])[..., 0] + model.b_cost
    for t, sl in cost_row_structure(nlp):
        if t.kind is Kind.COST_ABS:
            total = total + (model.w_cost[:, sl] * torch.abs(a[:, sl])).sum(-1)
        elif t.kind is Kind.COST_HINGE:
            total = total + (model.w_cost[:, sl]
                             * torch.clamp_min(a[:, sl], 0.0)).sum(-1)
    return total


def eval_model_cnt_viols(nlp: Nlp, model: ConvexModel, x) -> torch.Tensor:
    """Per-group violations [B, num_cnt_groups] of the linearized
    constraints at x."""
    g = (model.A_cnt @ x[..., None])[..., 0] + model.b_cnt
    d = _interval_dist(g, model.l_cnt, model.u_cnt)
    vals = [_group_reduce(d[:, sl], t) for t, sl, _ in cnt_group_structure(nlp)]
    return torch.cat(vals, -1) if vals else x.new_zeros(x.shape[0], 0)


# ----------------------------------------------------------------------
# Structured (banded) convexification: consumed by the block QP path.

class StructuredModel(NamedTuple):
    """Quadratic cost model plus banded constraint/penalty rows.

    Row order: [cnt-set rows; abs/hinge cost rows].  All fields carry the
    batch axis first (``is_pen`` too, so lane gathers treat every field
    alike)."""

    P: torch.Tensor       # [B, n, n]
    q: torch.Tensor       # [B, n]
    c0: torch.Tensor      # [B]
    W: torch.Tensor       # [B, m, w] banded window weights
    b: torch.Tensor       # [B, m] residual offsets (a(x) = C x + b)
    l: torch.Tensor       # [B, m]
    u: torch.Tensor       # [B, m]
    is_pen: torch.Tensor  # [B, m] bool: penalty-cost row (vs cnt row)
    pen_w: torch.Tensor   # [B, m] penalty weight of cost rows (0 for cnt)


def structured_sets(nlp: Nlp) -> list:
    """Sets contributing banded rows, in QP row order."""
    out = [t for t, _ in cnt_row_structure(nlp)]
    out += [t for t, _ in cost_row_structure(nlp)
            if t.kind in PENALTY_COST_KINDS]
    return out


def supports_structured(nlp: Nlp) -> bool:
    return all(t.banded_jac is not None for t in structured_sets(nlp))


def structured_band(nlp: Nlp) -> tuple[np.ndarray, int]:
    """(starts [m_rows], width) of the combined banded matrix (static)."""
    w = max(t.band_width for t in structured_sets(nlp))
    starts = np.concatenate([np.asarray(t.band_starts)
                             for t in structured_sets(nlp)])
    return starts, w


def block_half_band(nlp: Nlp, D: int, K: int) -> int | None:
    """Half-bandwidth, in steps of ``D`` columns, of the block QP's x-update
    matrix M = P + sigma I + C'RC + diag(rho b^2) (static, from the term
    sets alone): C'RC couples the K steps of a row window, P the steps one
    squared cost row spans (its ``jac_band``); a diagonal-Hessian cost
    couples none.  None (dense) where a squared cost states no columns or
    a Hessian is full."""
    hb = K - 1
    for t in nlp.cost_sets:
        if t.kind in PENALTY_COST_KINDS or t.kind is Kind.COST_GENERIC_DIAG:
            continue                # rows of C, or a diagonal
        if t.kind is not Kind.COST_SQ or t.jac_band is None:
            return None
        starts, width = np.asarray(t.jac_band[0]), t.jac_band[1]
        if starts.size:
            last = np.minimum(starts + width - 1, nlp.n - 1)
            hb = max(hb, int((last // D - starts // D).max()))
    return hb


def _band_index(owner, starts, w, n, device) -> torch.Tensor:
    """[rows, w] columns of banded rows starting at ``starts`` (clamped to
    n - 1), on ``device``, kept on ``owner``."""
    return on_device(owner, ("band", w, n), lambda: np.minimum(
        np.asarray(starts)[:, None] + np.arange(w), n - 1), device)


def convexify_structured(nlp: Nlp, x, params, jac_cache=None
                         ) -> StructuredModel:
    """Quadratic cost model plus banded constraint/penalty rows at x."""
    B, n = x.shape
    _, w = structured_band(nlp)
    P, q, c0, _, _, _ = _convexify_costs(nlp, x, params, jac_cache,
                                         pen_rows=False)
    W_rows, b_rows, l_rows, u_rows, pen_rows, penw_rows = [], [], [], [], [], []
    inf = float("inf")
    for t in structured_sets(nlp):
        if t.val_banded_jac is not None:
            r, Wt = t.val_banded_jac(x, params)
        else:
            r, Wt = t.fn(x, params), t.banded_jac(x, params)
        if t.band_width != w:
            Wt = torch.cat([Wt, Wt.new_zeros(B, t.n_rows, w - t.band_width)],
                           -1)
        idx = _band_index(t, t.band_starts, w, n, x.device)
        b = r - (Wt * x[:, idx]).sum(-1)
        W_rows.append(Wt)
        b_rows.append(b)
        zeros = x.new_zeros(B, t.n_rows)
        if t.kind is Kind.CNT_EQ:
            l_rows.append(zeros)
            u_rows.append(zeros)
            pen_rows.append(torch.zeros_like(zeros, dtype=torch.bool))
            penw_rows.append(zeros)
        elif t.kind is Kind.CNT_INEQ:
            l_rows.append(torch.full_like(zeros, -inf))
            u_rows.append(zeros)
            pen_rows.append(torch.zeros_like(zeros, dtype=torch.bool))
            penw_rows.append(zeros)
        else:
            l_rows.append(zeros if t.kind is Kind.COST_ABS
                          else torch.full_like(zeros, -inf))
            u_rows.append(zeros)
            pen_rows.append(torch.ones_like(zeros, dtype=torch.bool))
            penw_rows.append(_weights(t, params, x))
    return StructuredModel(
        P=P, q=q, c0=c0, W=torch.cat(W_rows, 1), b=torch.cat(b_rows, 1),
        l=torch.cat(l_rows, 1), u=torch.cat(u_rows, 1),
        is_pen=torch.cat(pen_rows, 1), pen_w=torch.cat(penw_rows, 1))


def structured_row_values(nlp: Nlp, sm: StructuredModel, x):
    """a(x) = C x + b for all banded rows."""
    starts, w = structured_band(nlp)
    idx = _band_index(nlp, starts, w, nlp.n, x.device)
    return (sm.W * x[:, idx]).sum(-1) + sm.b


def structured_model_cost_total(nlp: Nlp, sm: StructuredModel, x):
    total = 0.5 * (x * (sm.P @ x[..., None])[..., 0]).sum(-1) \
        + (sm.q * x).sum(-1) + sm.c0
    a = structured_row_values(nlp, sm, x)
    d = _interval_dist(a, sm.l, sm.u)
    return total + torch.where(sm.is_pen, sm.pen_w * d,
                               torch.zeros_like(d)).sum(-1)


def structured_model_cnt_viols(nlp: Nlp, sm: StructuredModel, x):
    a = structured_row_values(nlp, sm, x)
    d = _interval_dist(a, sm.l, sm.u)
    vals = [_group_reduce(d[:, sl], t)
            for t, sl, _ in cnt_group_structure(nlp)]
    return torch.cat(vals, -1) if vals else x.new_zeros(x.shape[0], 0)
