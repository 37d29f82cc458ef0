"""Trust-region SQP with L1 exact-penalty outer loop, on batches of lanes.

Counterpart of ``trajopt_tpu/sqp/solver.py`` (``make_solver``): the
algorithm of ``sco::BasicTrustRegionSQP::optimize()`` as three nested
loops -- penalty escalation, SQP convexification and the trust-region
accept/reject loop -- with the ADMM warm start (and, on the block path, the
KKT inverse) carried across iterations.  Its QP back ends: the dense ADMM
(``qp/admm.py``) or the dense IPM (``qp/ipm.py``, ``qp_algorithm="ipm"``);
with ``structured=True`` the block-banded ADMM (``qp/admm_block.py``) where
the row windows are step-aligned, else the gather-banded ADMM
(``qp/admm_structured.py``).  Also ported: the second-chance restarts and
their multi-start family (``params["restart_inits"]``), the saturated-dual
rescale (``rescale_duals_on_escalation``) and per-iteration callbacks with
``STOPPED_BY_CALLBACK``.

The JAX solver is written per problem and batched by ``vmap`` over its
``lax.while_loop``s, so a lane whose loop condition is false keeps its
state while other lanes iterate.  Here the batch is the leading axis and
every loop runs while any lane is live; each pass gathers the live lanes,
steps them, and scatters the results back.  Lanes never mix, so a lane's
result does not depend on its neighbours, exactly as under ``vmap``.

The sync-free regions of a pass -- the convexification (with the block
QP's equilibration and system, and its Cholesky inverse where no seed is
carried), the dense QP's preparation, the exact evaluation with the
accept/shrink bookkeeping, and the solve's initial convexification and
evaluation -- run through ``utils/aot_cache.py``: on the card each is
captured once per (region, lane bucket) as a CUDA graph and replayed, the
counterpart of ``jax.jit``.  What syncs with the host stays eager: the
live-lane gathers, the trust-region loop, the ADMM chunk loops, the
Newton-Schulz refresh, the step tail and callbacks.  A region runs at
its live lanes' bucket (``aot_cache.bucket``) on every device, the pad
lanes repeating the first live lane and dropped on return.

Nothing of the JAX ``make_solver`` is left out; like it, the solver has
no wall clock (``SQPParams.max_time`` is read by the JAX package's
reference solver only).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from trajopt_tpu_torch.qp import banded as bd
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp.admm import (QPData, prepare_qp,
                                       solve_qp_prepared)
from trajopt_tpu_torch.qp.admm_block import (BlockQP, block_system,
                                             invert_block_system,
                                             solve_qp_block_prepared)
from trajopt_tpu_torch.qp.admm_structured import (StructuredQP,
                                                  solve_qp_structured)
from trajopt_tpu_torch.qp.ipm import IPMConfig, solve_qp_ipm
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.nlp import ConvexModel, Nlp, StructuredModel
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.utils import aot_cache
from trajopt_tpu_torch.utils.profiling import host_read, span


class SQPResult(NamedTuple):
    x: torch.Tensor             # [B, n] final iterates
    status: torch.Tensor        # [B] int32 SQPStatus codes
    cost_vals: torch.Tensor     # [B, n_cost_sets] exact per-set costs
    cnt_viols: torch.Tensor     # [B, num_cnt_groups] exact violations
    total_cost: torch.Tensor    # [B]
    merit_coeffs: torch.Tensor  # [B, num_cnt_groups]
    box_size: torch.Tensor      # [B]
    n_iter: torch.Tensor        # [B]
    n_qp_solves: torch.Tensor   # [B]
    n_func_evals: torch.Tensor  # [B]


class _State(NamedTuple):
    x: torch.Tensor
    cost_vals: torch.Tensor
    cnt_viols: torch.Tensor
    merit_coeffs: torch.Tensor
    box_size: torch.Tensor
    merit_increases: torch.Tensor
    iter_in_round: torch.Tensor
    restarts_used: torch.Tensor
    total_iter: torch.Tensor
    status: torch.Tensor
    n_qp_solves: torch.Tensor
    n_func_evals: torch.Tensor
    z: torch.Tensor             # ADMM warm start [B, m_qp]
    y: torch.Tensor
    minv: torch.Tensor          # [B, n, n] carried KKT inverse ([B, 0, 0]
    #                             when the Newton-Schulz refresh is off)


class _TrustState(NamedTuple):
    box_size: torch.Tensor
    done: torch.Tensor
    outcome: torch.Tensor
    qp_fails: torch.Tensor
    x: torch.Tensor
    cost_vals: torch.Tensor
    cnt_viols: torch.Tensor
    n_qp_solves: torch.Tensor
    n_func_evals: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor


_SHRINKING, _ACCEPTED, _CONVERGED_SMALL, _QP_FAILED = 0, 1, 2, 3


def _map(fn, *trees):
    """Apply ``fn`` to every tensor leaf of matching (named)tuple/dict
    trees; other leaves (plans, None) pass through from the first tree."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, tuple):
        parts = [_map(fn, *f) for f in zip(*trees)]
        return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    return t0


def _take(tree, idx):
    return tree if idx is None else _map(lambda t: t[idx], tree)


def _put(tree, idx, sub):
    if idx is None:
        return sub
    return _map(lambda t, s: t.index_copy(0, idx, s), tree, sub)


def _live(mask: torch.Tensor):
    """(any, idx): whether any lane is set, and the set lanes' indices
    (None when all are set, so the common case gathers nothing)."""
    idx = host_read("sqp", "live", torch.nonzero, mask).squeeze(1)
    if idx.numel() == 0:
        return False, None
    return True, (None if idx.numel() == mask.numel() else idx)


def _as_param(v, like: torch.Tensor):
    """A params value with its numbers and arrays as tensors on ``like``'s
    device (floating ones in its dtype), as a jitted function takes them:
    a region captured on the card would otherwise freeze a host value."""
    if isinstance(v, tuple):
        return tuple(_as_param(e, like) for e in v)
    if not isinstance(v, (np.ndarray, np.generic, list, int, float)):
        return v
    a = np.asarray(v)
    return torch.as_tensor(a, dtype=like.dtype if a.dtype.kind == "f"
                           else None, device=like.device)


def _cnt_row_coeffs(nlp: Nlp, merit_coeffs: torch.Tensor) -> torch.Tensor:
    """Per-group merit coefficients [B, groups] expanded to per-row
    penalty weights [B, cnt_rows]."""
    parts = []
    for t, _, gsl in nlp_mod.cnt_group_structure(nlp):
        cg = merit_coeffs[:, gsl]
        if t.groups is None:
            parts.append(cg.expand(-1, t.n_rows))
        else:
            parts.append(cg[:, nlp_mod.term_groups_index(t, cg.device)])
    if not parts:
        return merit_coeffs.new_zeros(merit_coeffs.shape[0], 0)
    return torch.cat(parts, -1)


def _structured_cnt_coeffs(nlp: Nlp, merit_coeffs: torch.Tensor):
    """Merit coefficients over ALL structured rows (trailing penalty-cost
    rows get a placeholder that pen_w overwrites)."""
    n_pen = sum(t.n_rows for t, _ in nlp_mod.cost_row_structure(nlp)
                if t.kind in nlp_mod.PENALTY_COST_KINDS)
    return torch.cat([_cnt_row_coeffs(nlp, merit_coeffs),
                      merit_coeffs.new_zeros(merit_coeffs.shape[0], n_pen)],
                     -1)


def _penalty_cost_rows(nlp: Nlp, model: ConvexModel):
    """QP rows of the abs/hinge cost sets: (A [B,rows,n], l, u, c
    [B,rows]) on a(x) = A x + b; squared rows live in (P, q)."""
    A_rows, l_rows, u_rows, c_rows = [], [], [], []
    for t, sl in nlp_mod.cost_row_structure(nlp):
        if t.kind not in nlp_mod.PENALTY_COST_KINDS:
            continue
        b = model.b_cost[:, sl]
        A_rows.append(model.A_cost[:, sl])
        l_rows.append(-b if t.kind is nlp_mod.Kind.COST_ABS
                      else torch.full_like(b, -float("inf")))
        u_rows.append(-b)
        c_rows.append(model.w_cost[:, sl])
    like = model.q
    return (nlp_mod._cat_rows(A_rows, like, nlp.n),
            *(nlp_mod._cat_rows(r, like) for r in (l_rows, u_rows, c_rows)))


def num_qp_rows(nlp: Nlp) -> int:
    """Dense QP rows: constraint rows + abs/hinge cost rows + n box rows."""
    m_cnt = sum(t.n_rows for t in nlp.cnt_sets)
    m_pen = sum(t.n_rows for t in nlp.cost_sets
                if t.kind in nlp_mod.PENALTY_COST_KINDS)
    return m_cnt + m_pen + nlp.n


def build_qp(nlp: Nlp, model: ConvexModel, merit_coeffs: torch.Tensor,
             lb_box: torch.Tensor, ub_box: torch.Tensor) -> QPData:
    """The dense trust-region QP: constraint rows weighted by their group's
    merit coefficient, abs/hinge cost rows by their weight, then the hard
    box rows [lb_box, ub_box]; constraint rows bound z = A x in
    [l - b, u - b]."""
    A_pen, l_pen, u_pen, c_pen = _penalty_cost_rows(nlp, model)
    B, n = model.q.shape
    eye = torch.eye(n, dtype=model.q.dtype, device=model.q.device)
    return QPData(
        P=model.P, q=model.q,
        A=torch.cat([model.A_cnt, A_pen, eye.expand(B, n, n)], 1),
        l=torch.cat([model.l_cnt - model.b_cnt, l_pen, lb_box], -1),
        u=torch.cat([model.u_cnt - model.b_cnt, u_pen, ub_box], -1),
        c=torch.cat([_cnt_row_coeffs(nlp, merit_coeffs), c_pen,
                     torch.full_like(lb_box, float("inf"))], -1))


def block_qp(nlp: Nlp, plan: bb.BlockPlan, model: StructuredModel,
             merit_coeffs: torch.Tensor, x: torch.Tensor) -> BlockQP:
    """The box-independent block QP of a structured model: constraint
    rows weighted by their group's merit coefficient, penalty-cost rows
    by their weight, both in block row order (its lb/ub are placeholders
    set to ``x``; the trust box is passed per solve)."""
    row_c = torch.where(model.is_pen, model.pen_w,
                        _structured_cnt_coeffs(nlp, merit_coeffs))
    inf = float("inf")
    return BlockQP(
        P=model.P, q=model.q, C=bb.from_rows(model.W, plan),
        l=bb.to_block(model.l - model.b, plan, -inf),
        u=bb.to_block(model.u - model.b, plan, inf),
        c=bb.to_block(row_c, plan, 0.0), lb=x, ub=x)


def banded_qp(nlp: Nlp, starts, model: StructuredModel,
              merit_coeffs: torch.Tensor, lb_box: torch.Tensor,
              ub_box: torch.Tensor) -> StructuredQP:
    """The gather-banded QP of a structured model (row windows at
    ``starts``): constraint rows weighted by their group's merit
    coefficient, penalty-cost rows by their weight, the trust box as the
    hard box."""
    row_c = torch.where(model.is_pen, model.pen_w,
                        _structured_cnt_coeffs(nlp, merit_coeffs))
    return StructuredQP(P=model.P, q=model.q,
                        C=bd.make_banded(model.W, starts, nlp.n),
                        l=model.l - model.b, u=model.u - model.b, c=row_c,
                        lb=lb_box, ub=ub_box)


def ipm_config(dtype: torch.dtype, eps_abs: float) -> IPMConfig:
    """The IPM settings of the solver's IPM branch: float32 cannot reach
    1e-8 KKT residuals, so it runs the barrier to its float32 floor (the
    JAX solver's switch on the trace dtype)."""
    if dtype == torch.float32:
        return IPMConfig(eps=max(1e-5, eps_abs), eps_res=1e-3, reg=1e-7)
    return IPMConfig(eps=min(1e-8, eps_abs))


def make_solver(nlp: Nlp, sqp: SQPParams = SQPParams(), callback=None,
                structured: bool = False):
    """Build ``solve(x0 [B, n], lb [B, n], ub [B, n], params) -> SQPResult``
    for a fixed problem structure; ``params`` is a dict of per-lane
    tensors with a leading ``B`` axis.  Its optional ``"restart_inits"``
    entry, ``[B, R, ...]`` reshaped to ``[B, R, n]``, is a multi-start
    family: the last R second-chance restarts (``max_restarts``) re-seed
    the lane from its rows instead of restarting in place; it never
    reaches the term functions.

    ``structured=False`` solves each trust-region QP densely (ADMM, or the
    IPM with ``qp_algorithm="ipm"``); ``structured=True`` on the
    block-banded QP when the row windows are step-aligned and the problem
    has a (T, D) layout, else on the gather-banded QP (every constraint and
    penalty set needs ``banded_jac``; ADMM only).

    ``callback(total_iter, x, cost_vals, cnt_viols, merit_coeffs,
    box_size)`` is called at the top of each SQP pass with the live lanes
    (in lane order; see ``callbacks.py``) and may return a per-lane stop
    mask: a stopped lane keeps its state and ends with
    ``STOPPED_BY_CALLBACK`` and one more iteration counted."""
    if sqp.qp_algorithm not in ("admm", "ipm"):
        raise ValueError(f"unknown qp_algorithm {sqp.qp_algorithm!r}")
    if sqp.qp_algorithm == "ipm" and structured:
        raise ValueError("qp_algorithm='ipm' supports the dense path only "
                         "(the banded/block streams are ADMM-specific)")
    n = nlp.n
    n_cnt = nlp_mod.num_cnt_groups(nlp)
    cfg = sqp.qp
    plan = None
    if structured:
        if not nlp_mod.supports_structured(nlp):
            missing = [t.name for t in nlp_mod.structured_sets(nlp)
                       if t.banded_jac is None]
            raise ValueError(f"structured=True requires banded_jac on all "
                             f"constraint/penalty sets; missing on "
                             f"{missing}")
        starts, band_w = nlp_mod.structured_band(nlp)
        if nlp.block is not None:
            try:
                plan = bb.make_plan(starts, band_w, nlp.block[0],
                                    nlp.block[1])
            except ValueError:
                plan = None          # not step-aligned: gather-banded
        m_rows = plan.m_blk if plan is not None else int(starts.shape[0])
        m_qp = m_rows + n
    else:
        m_qp = num_qp_rows(nlp)
    use_block = plan is not None
    ns_refresh = use_block and cfg.ns_refresh

    graphs, pools = {}, {}
    # A user's term function may copy a host constant to the card, which a
    # capture cannot hold: the regions that evaluate terms then run eagerly
    # (decided here, once, from the Nlp; never after a failed capture).
    user_code = nlp_mod.runs_user_code(nlp)

    def region(name: str, fn, args: tuple, B: int, terms: bool = True):
        """``fn(*args)`` on the live lanes ``args`` hold, run at their
        bucket (pad lanes repeat the first live lane and are dropped on
        return); on the card through the solver's capture of (region,
        bucket), all in one memory pool a device, unless the region
        evaluates ``terms`` of an Nlp that runs user code."""
        lead = aot_cache.flatten(args)[0][0]
        k, dev = lead.shape[0], lead.device
        padded = aot_cache.pad_lanes(args, aot_cache.bucket(k, B))
        if terms and user_code:
            return aot_cache.take_lanes(fn(*padded), k)
        if dev.type == "cuda" and dev not in pools:
            pools[dev] = torch.cuda.graph_pool_handle()
        f = aot_cache.cached_export(fn, padded, f"sqp.{name}",
                                    pool=pools.get(dev), memo=graphs)
        return aot_cache.take_lanes(f(*padded), k)

    def merit(cost_vals, cnt_viols, merit_coeffs):
        return cost_vals.sum(-1) + (merit_coeffs * cnt_viols).sum(-1)

    def convexify_region(x, params, jac_cache, merit_coeffs):
        """(model, prep, M): the convex model at x; on the block path the
        step's equilibrated QP (every trust-region QP of the step reuses
        it) with its Cholesky inverse, or with the Newton-Schulz refresh
        its system M, inverted outside the region."""
        if structured:
            model = nlp_mod.convexify_structured(nlp, x, params, jac_cache)
        else:
            model = nlp_mod.convexify(nlp, x, params, jac_cache)
        if not use_block:
            return model, None, None
        prep, M = block_system(block_qp(nlp, plan, model, merit_coeffs, x),
                               cfg)
        if ns_refresh:
            return model, prep, M
        return model, invert_block_system(prep, M, cfg), None

    def init_region(x0, params, coeffs0):
        """The solve's start: the affine sets' Jacobians, the exact costs
        and violations at x0 and, with the Newton-Schulz refresh, the
        carried KKT inverse seeded by one Cholesky."""
        jac_cache = nlp_mod.linear_jacobians(nlp, x0, params)
        minv = x0.new_zeros(x0.shape[0], 0, 0)
        if ns_refresh:
            model0 = nlp_mod.convexify_structured(nlp, x0, params, jac_cache)
            minv = invert_block_system(*block_system(
                block_qp(nlp, plan, model0, coeffs0, x0), cfg), cfg).Minv
        return (jac_cache, minv, nlp_mod.eval_exact_costs(nlp, x0, params),
                nlp_mod.eval_exact_cnt_viols(nlp, x0, params))

    def dense_prepare_region(x_state, box_size, lb, ub, model, merit_coeffs,
                             x, z, y):
        """The dense ADMM's trust-region QP (the trust box is the variable
        bounds clamped around the iterate), equilibrated, warm-started and
        (under fixed rho) factored."""
        lb_box = torch.maximum(lb, x_state - box_size[:, None])
        ub_box = torch.minimum(ub, x_state + box_size[:, None])
        return prepare_qp(build_qp(nlp, model, merit_coeffs, lb_box, ub_box),
                          x, z, y, cfg)

    def escalation_row_ratio(old_coeffs, new_coeffs):
        """Per-QP-row (dual rescale factor, old weight) [B, m_qp] for a
        merit-coefficient change, in the carried y's row layout; the
        factor is 1 on rows whose weight did not change (other groups,
        penalty-cost rows, padded and box rows)."""
        rows = _structured_cnt_coeffs if structured else _cnt_row_coeffs
        old = rows(nlp, old_coeffs)
        new = rows(nlp, new_coeffs)
        r = torch.where(old > 0, new / torch.clamp_min(old, 1e-30),
                        torch.ones_like(old))
        if use_block:
            r = bb.to_block(r, plan, 1.0)
            old = bb.to_block(old, plan, 0.0)
        pad = m_qp - r.shape[1]
        return (torch.cat([r, r.new_ones(r.shape[0], pad)], -1),
                torch.cat([old, old.new_zeros(old.shape[0], pad)], -1))

    def trust_body(ts: _TrustState, ctx) -> _TrustState:
        x_state, merit_coeffs, old_merit, model, prep, params, lb, ub, B = ctx
        with span("sqp.qp"):
            if not structured and sqp.qp_algorithm == "admm":
                with span("qp.prepare"):
                    dprep = region("qp_prepare", dense_prepare_region,
                                   (x_state, ts.box_size, lb, ub, model,
                                    merit_coeffs, ts.x, ts.z, ts.y), B,
                                   terms=False)
                res = solve_qp_prepared(dprep, cfg)
            else:
                # Trust box = variable bounds clamped around the iterate.
                lb_box = torch.maximum(lb, x_state - ts.box_size[:, None])
                ub_box = torch.minimum(ub, x_state + ts.box_size[:, None])
                if use_block:
                    res = solve_qp_block_prepared(
                        prep, lb_box, ub_box, ts.x, zc0=ts.z[:, :m_rows],
                        zb0=ts.z[:, m_rows:], yc0=ts.y[:, :m_rows],
                        yb0=ts.y[:, m_rows:], cfg=cfg)
                elif structured:
                    res = solve_qp_structured(
                        banded_qp(nlp, starts, model, merit_coeffs, lb_box,
                                  ub_box),
                        ts.x, zc0=ts.z[:, :m_rows], zb0=ts.z[:, m_rows:],
                        yc0=ts.y[:, :m_rows], yb0=ts.y[:, m_rows:], cfg=cfg)
                else:
                    res = solve_qp_ipm(
                        build_qp(nlp, model, merit_coeffs, lb_box, ub_box),
                        ts.x, cfg=ipm_config(x_state.dtype, cfg.eps_abs))
        with span("sqp.evaluate"):
            return region("evaluate", evaluate_region,
                          (ts, merit_coeffs, old_merit, model, params,
                           res.x, res.z, res.y), B)

    def evaluate_region(ts: _TrustState, merit_coeffs, old_merit, model,
                        params, new_x, res_z, res_y) -> _TrustState:
        """The QP step's model and exact merit, and the trust region's
        accept / shrink / QP-failure bookkeeping."""
        dtype = new_x.dtype
        qp_bad = ~torch.isfinite(new_x).all(-1)
        if structured:
            model_cost = nlp_mod.structured_model_cost_total(nlp, model,
                                                             new_x)
            model_viols = nlp_mod.structured_model_cnt_viols(nlp, model,
                                                             new_x)
        else:
            model_cost = nlp_mod.model_cost_total(nlp, model, new_x)
            model_viols = nlp_mod.eval_model_cnt_viols(nlp, model, new_x)
        model_merit = model_cost + (merit_coeffs * model_viols).sum(-1)
        new_cost_vals = nlp_mod.eval_exact_costs(nlp, new_x, params)
        new_cnt_viols = nlp_mod.eval_exact_cnt_viols(nlp, new_x, params)
        new_merit = merit(new_cost_vals, new_cnt_viols, merit_coeffs)

        approx_improve = old_merit - model_merit
        exact_improve = old_merit - new_merit
        ratio = exact_improve / approx_improve
        exact_bad = ~torch.isfinite(new_merit)
        small = approx_improve < sqp.min_approx_improve
        small |= (approx_improve / old_merit) < sqp.min_approx_improve_frac
        accept = (~small) & (exact_improve > 0) & \
            (ratio >= sqp.improve_ratio_threshold) & (~exact_bad)
        shrink = (~small) & (~accept)

        # QP failure path (optimizers.cpp:817-842)
        fails = ts.qp_fails + qp_bad.to(torch.int32)
        last_try = fails >= sqp.max_qp_solver_failures
        box_on_fail = torch.where(
            fails == sqp.max_qp_solver_failures - 1,
            torch.full_like(ts.box_size, sqp.min_trust_box_size),
            ts.box_size * sqp.trust_shrink_ratio)
        new_box = torch.where(
            accept, ts.box_size * sqp.trust_expand_ratio,
            torch.where(shrink, ts.box_size * sqp.trust_shrink_ratio,
                        ts.box_size))

        def code(c):
            return torch.full_like(ts.outcome, c)

        outcome = torch.where(
            qp_bad,
            torch.where(last_try, code(_QP_FAILED), code(_SHRINKING)),
            torch.where(small, code(_CONVERGED_SMALL),
                        torch.where(accept, code(_ACCEPTED),
                                    code(_SHRINKING))))
        take = (accept & ~qp_bad)[:, None]
        keep = qp_bad[:, None]
        return _TrustState(
            box_size=torch.where(qp_bad, box_on_fail, new_box).to(dtype),
            done=torch.where(qp_bad, last_try, small | accept),
            outcome=outcome,
            qp_fails=fails,
            x=torch.where(take, new_x, ts.x),
            cost_vals=torch.where(take, new_cost_vals, ts.cost_vals),
            cnt_viols=torch.where(take, new_cnt_viols, ts.cnt_viols),
            n_qp_solves=ts.n_qp_solves + 1,
            n_func_evals=ts.n_func_evals + 1,
            z=torch.where(keep, ts.z, res_z),
            y=torch.where(keep, ts.y, res_y))

    def trust_loop(state: _State, model, prep, params, lb, ub,
                   B: int) -> _TrustState:
        old_merit = merit(state.cost_vals, state.cnt_viols,
                          state.merit_coeffs)
        ts = _TrustState(
            box_size=state.box_size,
            done=torch.zeros_like(state.status, dtype=torch.bool),
            outcome=torch.full_like(state.status, _SHRINKING),
            qp_fails=torch.zeros_like(state.status),
            x=state.x, cost_vals=state.cost_vals, cnt_viols=state.cnt_viols,
            n_qp_solves=state.n_qp_solves, n_func_evals=state.n_func_evals,
            z=state.z, y=state.y)
        ctx = (state.x, state.merit_coeffs, old_merit, model, prep, params,
               lb, ub, B)
        while True:
            # Bounded by box shrink like the reference's inner while, plus
            # the static max_trust_iter cap on QP solves per step.
            go = ((~ts.done) & (ts.box_size >= sqp.min_trust_box_size)
                  & (ts.n_qp_solves - state.n_qp_solves
                     < sqp.max_trust_iter))
            anyone, idx = _live(go)
            if not anyone:
                return ts
            ts = _put(ts, idx, trust_body(_take(ts, idx), _take(ctx, idx)))

    def sqp_step(state: _State, params, lb, ub, jac_cache, r_inits,
                 B: int) -> _State:
        with span("sqp.convexify"):
            model, prep, M = region(
                "convexify", convexify_region,
                (state.x, params, jac_cache, state.merit_coeffs), B)
        new_minv = state.minv
        if ns_refresh:
            with span("qp.prepare"):
                prep = invert_block_system(prep, M, cfg, minv0=state.minv)
            new_minv = prep.Minv
        ts = trust_loop(state, model, prep, params, lb, ub, B)
        dtype = state.x.dtype

        if n_cnt == 0:
            max_viol = state.x.new_zeros(state.x.shape[0])
        else:
            max_viol = torch.amax(ts.cnt_viols, -1)
        viols_satisfied = max_viol < sqp.cnt_tolerance
        iter_next = state.iter_in_round + 1
        hit_iter_limit = iter_next >= sqp.max_iter

        # "converged" paths -> penalty adjustment (optimizers.cpp:938-968)
        conv = (ts.outcome == _CONVERGED_SMALL) | \
            (ts.box_size < sqp.min_trust_box_size)
        qp_failed = ts.outcome == _QP_FAILED
        pen_done_ok = conv & viols_satisfied
        last_round = state.merit_increases + 1 >= sqp.max_merit_coeff_increases
        pen_escalate = conv & (~viols_satisfied)
        pen_exhausted = pen_escalate & last_round
        # Second-chance restart from the current iterate (max_restarts).
        restart = pen_exhausted & (state.restarts_used < sqp.max_restarts)
        pen_exhausted = pen_exhausted & (~restart)

        coeffs = state.merit_coeffs
        if sqp.inflate_constraints_individually and n_cnt > 0:
            inflated = torch.where(
                ts.cnt_viols > sqp.cnt_tolerance,
                coeffs * sqp.merit_coeff_increase_ratio, coeffs)
        else:
            inflated = coeffs * sqp.merit_coeff_increase_ratio
        new_coeffs = torch.where(pen_escalate[:, None], inflated, coeffs)
        new_coeffs = torch.where(
            restart[:, None],
            torch.full_like(new_coeffs, sqp.restart_merit_coeff),
            new_coeffs)

        init_box = torch.full_like(ts.box_size, sqp.initial_trust_box_size)
        if sqp.box_reset_to_initial:
            box_reset = init_box
        else:
            box_reset = torch.maximum(
                ts.box_size, torch.full_like(
                    ts.box_size,
                    sqp.min_trust_box_size / sqp.trust_shrink_ratio * 1.5))
        new_box = torch.where(pen_escalate, box_reset, ts.box_size)
        new_box = torch.where(restart, init_box, new_box)

        # Dual warm-start rescale on a coefficient change: only saturated
        # rows (|y| at their old weight, i.e. still violated) scale with
        # it; active-but-satisfied rows have interior duals that do not.
        new_y = ts.y
        if sqp.rescale_duals_on_escalation and n_cnt > 0:
            ratio, c_old = escalation_row_ratio(state.merit_coeffs,
                                                new_coeffs)
            saturated = torch.abs(ts.y) >= 0.9 * c_old
            ratio = torch.where(saturated & (c_old > 0), ratio,
                                torch.ones_like(ratio))
            new_y = torch.where((pen_escalate | restart)[:, None],
                                ts.y * ratio, ts.y)

        # Multi-start restart: the last R restarts re-seed x from the
        # lane's family (earlier ones stay in place).  A re-seeded lane
        # gets the box-clipped row, fresh exact evaluations (counted as
        # one, as in JAX) and zero duals; the carried KKT inverse is left
        # to the next step's Newton-Schulz refresh, and no best iterate
        # is kept.
        new_x, new_z = ts.x, ts.z
        new_cost_vals, new_cnt_viols = ts.cost_vals, ts.cnt_viols
        n_fev = ts.n_func_evals
        if r_inits is not None:
            n_family = r_inits.shape[1]
            j0 = max(0, sqp.max_restarts - n_family)
            use_alt = restart & (state.restarts_used >= j0)
            alt_idx = host_read("sqp", "restart", torch.nonzero,
                                use_alt).squeeze(1)
            if alt_idx.numel():
                k = torch.clamp(state.restarts_used[alt_idx] - j0, 0,
                                n_family - 1).long()
                alt = torch.minimum(torch.maximum(r_inits[alt_idx, k],
                                                  lb[alt_idx]), ub[alt_idx])
                p_alt = _take(params, alt_idx)
                new_x = new_x.index_copy(0, alt_idx, alt)
                new_cost_vals = new_cost_vals.index_copy(
                    0, alt_idx, nlp_mod.eval_exact_costs(nlp, alt, p_alt))
                new_cnt_viols = new_cnt_viols.index_copy(
                    0, alt_idx, nlp_mod.eval_exact_cnt_viols(nlp, alt, p_alt))
                new_z = new_z.index_fill(0, alt_idx, 0.0)
                new_y = new_y.index_fill(0, alt_idx, 0.0)
                n_fev = n_fev + use_alt.to(n_fev.dtype)

        # Iteration limit exits the whole solve (optimizers.cpp:922-934).
        iter_exit = (~conv) & (~qp_failed) & hit_iter_limit

        def code(c):
            return torch.full_like(state.status, c)

        status = state.status
        status = torch.where(qp_failed, code(SQPStatus.FAILED), status)
        status = torch.where(pen_done_ok, code(SQPStatus.CONVERGED), status)
        status = torch.where(pen_exhausted,
                             code(SQPStatus.PENALTY_ITERATION_LIMIT), status)
        status = torch.where(
            iter_exit,
            torch.where(viols_satisfied, code(SQPStatus.CONVERGED),
                        code(SQPStatus.SCO_ITERATION_LIMIT)),
            status)
        zero = torch.zeros_like(state.merit_increases)
        return _State(
            x=new_x, cost_vals=new_cost_vals, cnt_viols=new_cnt_viols,
            merit_coeffs=new_coeffs, box_size=new_box.to(dtype),
            merit_increases=torch.where(
                restart, zero,
                state.merit_increases + pen_escalate.to(torch.int32)),
            iter_in_round=torch.where(pen_escalate | restart, zero,
                                      iter_next),
            restarts_used=state.restarts_used + restart.to(torch.int32),
            total_iter=state.total_iter + 1,
            status=status,
            n_qp_solves=ts.n_qp_solves, n_func_evals=n_fev,
            z=new_z, y=new_y, minv=new_minv)

    def sqp_pass(state: _State, lane) -> _State:
        """One SQP iteration of the live lanes ``state``: the callback
        first (the reference checks its callbacks at the top of the
        iteration), then the step for every lane it did not stop."""
        if callback is None:
            return sqp_step(state, *lane)
        stop = callback(state.total_iter, state.x, state.cost_vals,
                        state.cnt_viols, state.merit_coeffs, state.box_size)
        if stop is None:
            return sqp_step(state, *lane)
        stop = torch.as_tensor(stop, dtype=torch.bool,
                               device=state.x.device).reshape(-1)
        new = state._replace(
            status=torch.where(stop, torch.full_like(
                state.status, SQPStatus.STOPPED_BY_CALLBACK), state.status),
            total_iter=state.total_iter + stop.to(torch.int32))
        go, idx = _live(~stop)
        if not go:
            return new
        return _put(new, idx, sqp_step(_take(state, idx), *_take(lane, idx)))

    def solve(x0: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
              params: Any) -> SQPResult:
        params = {k: _as_param(v, x0) for k, v in (params or {}).items()}
        B, dtype, dev = x0.shape[0], x0.dtype, x0.device
        r_inits = params.pop("restart_inits", None)
        if r_inits is not None:
            r_inits = torch.as_tensor(r_inits, dtype=dtype,
                                      device=dev).reshape(B, -1, n)
        # getClosestFeasiblePoint (modeling.cpp:260): box-only projection.
        x0 = torch.minimum(torch.maximum(x0, lb), ub)
        coeffs0 = x0.new_full((B, n_cnt), sqp.initial_merit_error_coeff)
        with span("sqp.init"):
            jac_cache, minv, cost_vals, cnt_viols = region(
                "init", init_region, (x0, params, coeffs0), B)

        def ints(v):
            return torch.full((B,), v, dtype=torch.int32, device=dev)

        state = _State(
            x=x0, cost_vals=cost_vals, cnt_viols=cnt_viols,
            merit_coeffs=coeffs0,
            box_size=x0.new_full((B,), sqp.initial_trust_box_size),
            merit_increases=ints(0), iter_in_round=ints(0),
            restarts_used=ints(0), total_iter=ints(0),
            status=ints(SQPStatus.RUNNING), n_qp_solves=ints(0),
            n_func_evals=ints(1),
            z=x0.new_zeros(B, m_qp), y=x0.new_zeros(B, m_qp),
            minv=minv)
        lane = (params, lb, ub, jac_cache, r_inits, B)
        while True:
            anyone, idx = _live(state.status == SQPStatus.RUNNING)
            if not anyone:
                break
            with span("sqp.pass"):
                state = _put(state, idx,
                             sqp_pass(_take(state, idx), _take(lane, idx)))
        return SQPResult(
            x=state.x, status=state.status, cost_vals=state.cost_vals,
            cnt_viols=state.cnt_viols, total_cost=state.cost_vals.sum(-1),
            merit_coeffs=state.merit_coeffs, box_size=state.box_size,
            n_iter=state.total_iter, n_qp_solves=state.n_qp_solves,
            n_func_evals=state.n_func_evals)

    return solve
