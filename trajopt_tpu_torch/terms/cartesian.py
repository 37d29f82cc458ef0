"""Cartesian terms: static and dynamic pose, Cartesian velocity, line
following, IK targets and singularity avoidance, on batched trajectories.

Counterpart of ``trajopt_tpu/terms/cartesian.py`` (the reference's
``kinematic_terms.cpp`` error calculators and the ifopt line / IK
constraints).  Every pose-style term's rows depend on one timestep's
joints, so each carries banded Jacobians (one step's columns) for the block
and gather-banded QPs beside its dense one; the rows are functions of
``q [B, n_dof]`` and their Jacobians come from ``torch.func.jacfwd`` under
``torch.func.vmap`` over the lanes (the JAX package differentiates its
per-problem function with ``jax.jacfwd`` / ``jax.vjp``).  ``cart_vel``
and ``avoid_singularity`` use the geometric Jacobian directly.

A target given as a params key (``cart_pose(target="key")``) reads
``params[key]`` per lane as a position ``[B, 3]`` (identity rotation) or as
an ``(R [B, 3, 3], p [B, 3])`` tuple, as the JAX term does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trajopt_tpu_torch.kinematics.chain import KinematicTree
from trajopt_tpu_torch.kinematics.transforms import (
    apply_tolerances, axis_angle_matrix, compose, rotvec_from_matrix,
    transform_error)
from trajopt_tpu_torch.sqp.nlp import (Consts, Kind, TermSet,
                                       banded_to_dense, one_lane)


def _step_q(x, t, n_steps, n_dof_total, n_dof):
    return x.reshape(x.shape[0], n_steps, n_dof_total)[:, t, :n_dof]


def _lane_jacfwd(rows_q, q, params):
    """(rows [B, k], Jacobian [B, k, n_dof]) of the batched ``rows_q`` per
    lane: forward mode over the lane's n_dof joints."""
    def f(qq, p):
        r = rows_q(qq[None], one_lane(p))[0]
        return r, r
    J, r = torch.func.vmap(torch.func.jacfwd(f, has_aux=True))(q, params)
    return r, J


def _step_local(rows_q, timestep, n_rows, n_steps, n_dof_total, n_dof, n):
    """Providers of a term whose rows depend on one timestep's joints:
    (fn, val_jac_fn, banded_jac, val_banded_jac, band_starts, band_width),
    the band being that step's ``n_dof_total`` columns."""
    band_starts = np.full((n_rows,), timestep * n_dof_total)

    def fn(x, params):
        return rows_q(_step_q(x, timestep, n_steps, n_dof_total, n_dof),
                      params)

    def val_banded_jac(x, params):
        r, J = _lane_jacfwd(rows_q, _step_q(x, timestep, n_steps,
                                            n_dof_total, n_dof), params)
        W = x.new_zeros(x.shape[0], n_rows, n_dof_total)
        W[..., :n_dof] = J
        return r, W

    def val_jac_fn(x, params):
        r, W = val_banded_jac(x, params)
        return r, banded_to_dense(W, band_starts, n)

    return (fn, val_jac_fn, lambda x, p: val_banded_jac(x, p)[1],
            val_banded_jac, band_starts, n_dof_total)


def _pose_term(name, rows_q, is_cost, cfs, n_rows, timestep, n_steps,
               n_dof_total, n_dof, kind_cost=Kind.COST_ABS,
               linear=False) -> TermSet:
    fn, vj, bj, vbj, starts, width = _step_local(
        rows_q, timestep, n_rows, n_steps, n_dof_total, n_dof,
        n_steps * n_dof_total)
    kind = kind_cost if is_cost else Kind.CNT_EQ
    weight = (lambda p: cfs) if is_cost else (lambda p: 1.0)
    return TermSet(name, kind, fn, n_rows, weight_fn=weight, linear=linear,
                   val_jac_fn=vj, banded_jac=bj, val_banded_jac=vbj,
                   band_starts=starts, band_width=width)


def _as_pose(pose):
    """Accept (R, p), 4x4, or p-only (identity rotation) -> numpy (R, p)."""
    if pose is None:
        return np.eye(3), np.zeros(3)
    if isinstance(pose, tuple):
        return np.asarray(pose[0], float), np.asarray(pose[1], float)
    pose = np.asarray(pose, float)
    if pose.shape == (4, 4):
        return pose[:3, :3], pose[:3, 3]
    if pose.shape == (3,):
        return np.eye(3), pose
    raise ValueError(f"bad pose spec shape {pose.shape}")


def _coeffs(coeffs, k):
    return np.ones(k) if coeffs is None else np.broadcast_to(
        np.asarray(coeffs, float), (k,)).copy()


def cart_pose(tree: KinematicTree, link: str, n_steps: int, timestep: int,
              *, is_cost: bool = True, target=None, tcp=None,
              target_tcp=None, coeffs=None,
              indices: Sequence[int] | None = None, upper_tolerance=None,
              lower_tolerance=None, n_dof_total: int | None = None,
              name: str | None = None) -> TermSet:
    """Pose term for one trajectory timestep (CartPoseTermInfo): the error
    ``calcTransformError(target, source)`` with tcp offsets, index masking
    and tolerance bands; a cost is an ABS penalty weighted by ``coeffs``,
    a constraint EQ rows scaled by them."""
    n_dof = tree.n_dof
    n_dof_total = n_dof_total or n_dof
    link_id = tree.link_id(link)
    idx = np.arange(6) if indices is None else np.asarray(indices)
    cfs = _coeffs(coeffs, len(idx))
    R_tcp, p_tcp = _as_pose(tcp)
    R_ttcp, p_ttcp = _as_pose(target_tcp)
    R_tgt, p_tgt = (np.eye(3), np.zeros(3)) if isinstance(target, str) \
        else _as_pose(target)
    has_tol = upper_tolerance is not None or lower_tolerance is not None
    consts = Consts(R_tcp=R_tcp, p_tcp=p_tcp, R_ttcp=R_ttcp, p_ttcp=p_ttcp,
                    R_tgt=R_tgt, p_tgt=p_tgt, cfs=cfs, idx=idx,
                    up=np.zeros(6) if upper_tolerance is None
                    else np.asarray(upper_tolerance, float),
                    lo=np.zeros(6) if lower_tolerance is None
                    else np.asarray(lower_tolerance, float))
    name = name or f"cart_pose_{link}_t{timestep}"

    def target_pose(params, q):
        if isinstance(target, str):
            tgt = params[target]
            if isinstance(tgt, tuple):
                return tgt
            return consts.get("R_tgt", q), tgt
        return consts.get("R_tgt", q), consts.get("p_tgt", q)

    def rows_q(q, params):
        R, p = tree.fk(q)
        R_src, p_src = compose(R[..., link_id, :, :], p[..., link_id, :],
                               consts.get("R_tcp", q), consts.get("p_tcp", q))
        R_t, p_t = compose(*target_pose(params, q), consts.get("R_ttcp", q),
                           consts.get("p_ttcp", q))
        e = transform_error(R_t, p_t, R_src, p_src)
        if has_tol:
            e = apply_tolerances(e, consts.get("lo", q), consts.get("up", q))
        e = e[..., consts.get("idx", q)]
        return e if is_cost else e * consts.get("cfs", q)

    return _pose_term(name, rows_q, is_cost, cfs, len(idx), timestep,
                      n_steps, n_dof_total, n_dof)


def dynamic_cart_pose(tree: KinematicTree, source_link: str,
                      target_link: str, n_steps: int, timestep: int, *,
                      is_cost: bool = True, tcp=None, target_tcp=None,
                      coeffs=None, indices: Sequence[int] | None = None,
                      n_dof_total: int | None = None,
                      name: str | None = None) -> TermSet:
    """Pose error between two moving robot frames
    (DynamicCartPoseErrCalculator)."""
    n_dof = tree.n_dof
    n_dof_total = n_dof_total or n_dof
    src_id = tree.link_id(source_link)
    tgt_id = tree.link_id(target_link)
    idx = np.arange(6) if indices is None else np.asarray(indices)
    cfs = _coeffs(coeffs, len(idx))
    R_tcp, p_tcp = _as_pose(tcp)
    R_ttcp, p_ttcp = _as_pose(target_tcp)
    consts = Consts(R_tcp=R_tcp, p_tcp=p_tcp, R_ttcp=R_ttcp, p_ttcp=p_ttcp,
                    cfs=cfs, idx=idx)
    name = name or f"dyn_cart_pose_{source_link}_{target_link}_t{timestep}"

    def rows_q(q, params):
        R, p = tree.fk(q)
        R_s, p_s = compose(R[..., src_id, :, :], p[..., src_id, :],
                           consts.get("R_tcp", q), consts.get("p_tcp", q))
        R_t, p_t = compose(R[..., tgt_id, :, :], p[..., tgt_id, :],
                           consts.get("R_ttcp", q), consts.get("p_ttcp", q))
        e = transform_error(R_t, p_t, R_s, p_s)[..., consts.get("idx", q)]
        return e if is_cost else e * consts.get("cfs", q)

    return _pose_term(name, rows_q, is_cost, cfs, len(idx), timestep,
                      n_steps, n_dof_total, n_dof)


def cart_vel(tree: KinematicTree, link: str, n_steps: int, *,
             max_displacement: float, first_step: int = 0,
             last_step: int = -1, is_cost: bool = False, coeffs=None,
             n_dof_total: int | None = None,
             name: str | None = None) -> TermSet:
    """Per-gap Cartesian displacement limit: rows [dp - limit; -dp - limit]
    for each xyz axis and gap (CartVelTermInfo / CartVelErrCalculator).
    Each gap's 6 rows cover its two steps' joints; their Jacobian is the
    link origin's linear geometric Jacobian at each end."""
    n_dof = tree.n_dof
    n_dof_total = n_dof_total or n_dof
    link_id = tree.link_id(link)
    if last_step <= -1:
        last_step = n_steps - 1
    gaps = np.arange(first_step, last_step)
    G = len(gaps)
    n = n_steps * n_dof_total
    name = name or f"cart_vel_{link}"
    c = 1.0 if coeffs is None else float(np.asarray(coeffs).reshape(()))
    consts = Consts(gaps=gaps)
    band_starts = np.repeat(gaps * n_dof_total, 6)
    band_width = 2 * n_dof_total

    def _qs(x):
        g = consts.get("gaps", x)
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        return qs[:, g], qs[:, g + 1]                    # [B, G, n_dof]

    def _rows(p0, p1):
        dp = p1[..., link_id, :] - p0[..., link_id, :]
        out = torch.cat([dp - max_displacement, -dp - max_displacement], -1)
        return (out * c).reshape(out.shape[0], -1)

    def fn(x, params):
        q0, q1 = _qs(x)
        return _rows(tree.fk(q0)[1], tree.fk(q1)[1])

    def val_banded_jac(x, params):
        q0, q1 = _qs(x)
        J0 = tree.jacobian(q0, link_id)[..., :3, :]      # [B, G, 3, n_dof]
        J1 = tree.jacobian(q1, link_id)[..., :3, :]
        B = x.shape[0]
        W = x.new_zeros(B, G, 6, band_width)
        W[..., :3, :n_dof] = -c * J0
        W[..., 3:, :n_dof] = c * J0
        W[..., :3, n_dof_total:n_dof_total + n_dof] = c * J1
        W[..., 3:, n_dof_total:n_dof_total + n_dof] = -c * J1
        return fn(x, params), W.reshape(B, 6 * G, band_width)

    def val_jac_fn(x, params):
        r, W = val_banded_jac(x, params)
        return r, banded_to_dense(W, band_starts, n)

    return TermSet(name, Kind.COST_HINGE if is_cost else Kind.CNT_INEQ, fn,
                   6 * G, val_jac_fn=val_jac_fn,
                   banded_jac=lambda x, p: val_banded_jac(x, p)[1],
                   val_banded_jac=val_banded_jac, band_starts=band_starts,
                   band_width=band_width)


def cart_line(tree: KinematicTree, link: str, n_steps: int, timestep: int,
              *, line_start, line_end, is_cost: bool = False, coeffs=None,
              indices: Sequence[int] | None = None, tcp=None,
              n_dof_total: int | None = None,
              name: str | None = None) -> TermSet:
    """Constrain a link pose to the segment between two poses
    (CartLineConstraint): the target is the nearest point of the segment
    (position: the clamped projection; orientation: slerp by the same
    parameter), then a cart_pose-style error to it."""
    n_dof = tree.n_dof
    n_dof_total = n_dof_total or n_dof
    link_id = tree.link_id(link)
    idx = np.arange(6) if indices is None else np.asarray(indices)
    cfs = _coeffs(coeffs, len(idx))
    R1, p1 = _as_pose(line_start)
    R2, p2 = _as_pose(line_end)
    R_tcp, p_tcp = _as_pose(tcp)
    consts = Consts(R1=R1, R2=R2, p1=p1, p2=p2, R_tcp=R_tcp, p_tcp=p_tcp,
                    cfs=cfs, idx=idx)
    name = name or f"cart_line_{link}_t{timestep}"

    def rows_q(q, params):
        R, p = tree.fk(q)
        R_src, p_src = compose(R[..., link_id, :, :], p[..., link_id, :],
                               consts.get("R_tcp", q), consts.get("p_tcp", q))
        c1, c2 = consts.get("p1", q), consts.get("p2", q)
        Ra, Rb = consts.get("R1", q), consts.get("R2", q)
        ab = c2 - c1
        t = torch.clamp(((p_src - c1) * ab).sum(-1) / ((ab * ab).sum()
                                                        + 1e-12), 0.0, 1.0)
        p_line = c1 + t[..., None] * ab
        # slerp: R(t) = R1 exp(t log(R1' R2))
        rv = rotvec_from_matrix(Ra.transpose(-1, -2) @ Rb)
        angle = torch.linalg.vector_norm(rv) + 1e-12
        R_line = Ra @ axis_angle_matrix(rv / angle, t * angle)
        e = transform_error(R_line, p_line, R_src, p_src)[
            ..., consts.get("idx", q)]
        return e if is_cost else e * consts.get("cfs", q)

    return _pose_term(name, rows_q, is_cost, cfs, len(idx), timestep,
                      n_steps, n_dof_total, n_dof)


def ik_constraint(tree: KinematicTree, link: str, n_steps: int,
                  timestep: int, *, target, q_seed, is_cost: bool = False,
                  coeffs=None, pos_only: bool = False,
                  n_dof_total: int | None = None,
                  name: str | None = None) -> TermSet:
    """Constrain a timestep's joints toward the IK solution of a target
    pose (InverseKinematicsConstraint: rows ``q_t - ik(target)``).  The IK
    solve runs once, in float64 on the CPU, when the term is built."""
    from trajopt_tpu_torch.kinematics.ik import solve_ik

    n_dof = tree.n_dof
    n_dof_total = n_dof_total or n_dof
    R_t, p_t = _as_pose(target)
    q_ik, _ = solve_ik(tree, link, R_t, p_t,
                       torch.as_tensor(np.asarray(q_seed, float)),
                       pos_only=pos_only)
    cfs = _coeffs(coeffs, n_dof)
    consts = Consts(q_ik=q_ik.numpy(), cfs=cfs)
    name = name or f"ik_{link}_t{timestep}"

    def rows_q(q, params):
        r = q - consts.get("q_ik", q)
        return r if is_cost else r * consts.get("cfs", q)

    return _pose_term(name, rows_q, is_cost, cfs, n_dof, timestep, n_steps,
                      n_dof_total, n_dof, kind_cost=Kind.COST_SQ,
                      linear=True)


def avoid_singularity(tree: KinematicTree, link: str, n_steps: int, *,
                      lambda_: float = 1.0e-3, coeff: float = 1.0,
                      first_step: int = 0, last_step: int = -1,
                      joints: Sequence[int] | None = None,
                      n_dof_total: int | None = None,
                      name: str | None = None) -> TermSet:
    """``err_t = 1/(sigma_min(J_t) + lambda) - 1/(0.1 + lambda)``, a hinge
    cost (AvoidSingularityErrCalculator); ``joints`` restricts J to a subset
    of columns (the Subset variant).  The gradient of the smallest singular
    value comes from autograd through ``torch.linalg.svdvals`` (each step's
    row depends on that step only, so one backward pass of the rows' sum
    gives every row's gradient)."""
    n_dof = tree.n_dof
    n_dof_total = n_dof_total or n_dof
    if last_step <= -1:
        last_step = n_steps - 1
    steps = np.arange(first_step, last_step + 1)
    S = len(steps)
    n = n_steps * n_dof_total
    name = name or f"avoid_singularity_{link}"
    threshold = 1.0 / (0.1 + lambda_)
    cols = None if joints is None else np.asarray(list(joints))
    link_id = tree.link_id(link)
    consts = Consts(steps=steps)
    band_starts = steps * n_dof_total

    def _qs(x):
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        return qs[:, consts.get("steps", x)]      # [B, S, n_dof]

    def err(q):
        J = tree.jacobian(q, link_id)
        if cols is not None:
            J = J[..., cols]
        s = torch.linalg.svdvals(J)
        return 1.0 / (s[..., -1] + lambda_) - threshold

    def fn(x, params):
        return err(_qs(x))

    def val_banded_jac(x, params):
        with torch.enable_grad():
            q = _qs(x).detach().requires_grad_(True)
            e = err(q)
            (g,) = torch.autograd.grad(e.sum(), q)
        W = x.new_zeros(x.shape[0], S, n_dof_total)
        W[..., :n_dof] = g
        return e.detach(), W

    def val_jac_fn(x, params):
        r, W = val_banded_jac(x, params)
        return r, banded_to_dense(W, band_starts, n)

    return TermSet(name, Kind.COST_HINGE, fn, S, weight_fn=lambda p: coeff,
                   val_jac_fn=val_jac_fn,
                   banded_jac=lambda x, p: val_banded_jac(x, p)[1],
                   val_banded_jac=val_banded_jac, band_starts=band_starts,
                   band_width=n_dof_total)
