"""Typed facade constraint classes over the ifopt component model.

Counterpart of ``trajopt_tpu/ifopt/constraints.py``: the concrete
constraint classes of the reference's ifopt stack, which the user composes
directly with variable sets, lowering through
:class:`trajopt_tpu_torch.ifopt.ConstraintSet` onto the functional SQP
core:

* ``JointPosConstraint`` / ``JointVelConstraint`` / ``JointAccelConstraint``
  / ``JointJerkConstraint`` -- per-node joint-state rows with per-dof
  targets and coefficient weighting
  (trajopt_ifopt/include/trajopt_ifopt/constraints/
  joint_velocity_constraint.h:43-110, joint_position_constraint.h,
  joint_acceleration_constraint.h, joint_jerk_constraint.h; value
  formulas from the matching src/constraints/*.cpp, including the
  backward-difference tail rows of accel/jerk).
* ``CartPosConstraint`` -- 6-dof (index-maskable) pose error of a robot
  link against a fixed target pose with source/target TCP offsets
  (cartesian_position_constraint.h, error = calcTransformError).
* ``CartLineConstraint`` -- pose error against the nearest point of a
  pose segment (clamped projection + slerp orientation,
  cartesian_line_constraint.cpp:119-149).
* ``InverseKinematicsConstraint`` -- joint-space error against the IK
  solution of a target pose (inverse_kinematics_constraint.cpp; the IK
  solve runs at construction, in float64, like the term-library
  counterpart ``terms/cartesian.py`` ``ik_constraint``).

Every set here is ``batched``: its values take a reader over ``[..., n]``
(one lane or the whole batch) on the port's batched ``KinematicTree.fk``
and ``kinematics/transforms.py``.

Coefficient semantics: the reference returns coefficients through
``getCoefficients()`` and the solver multiplies violations by them; here
the coefficients scale the rows AND bounds (an identical weighting of
the penalty while preserving the feasible set).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trajopt_tpu_torch.ifopt import Bounds, ConstraintSet, Var, _VarReader
from trajopt_tpu_torch.kinematics.chain import KinematicTree
from trajopt_tpu_torch.kinematics.transforms import (axis_angle_matrix,
                                                     compose,
                                                     rotvec_from_matrix,
                                                     transform_error)
from trajopt_tpu_torch.sqp.nlp import Consts
from trajopt_tpu_torch.terms.cartesian import _as_pose

__all__ = [
    "JointPosConstraint", "JointVelConstraint", "JointAccelConstraint",
    "JointJerkConstraint", "CartPosConstraint", "CartLineConstraint",
    "InverseKinematicsConstraint",
]


def _broadcast_coeffs(coeffs, n_dof: int, default: float, cls: str):
    """Reference coeff handling: empty -> default, scalar -> broadcast,
    else must match n_dof; all entries must be positive
    (joint_velocity_constraint.cpp:58-74)."""
    if coeffs is None:
        c = np.full(n_dof, float(default))
    else:
        c = np.asarray(coeffs, float).reshape(-1)
        if c.size == 1:
            c = np.full(n_dof, float(c[0]))
        elif c.size != n_dof:
            raise ValueError(f"{cls}: coeff must be scalar or size n_dof")
    if not np.all(c > 0):
        raise ValueError(f"{cls}: coeff must be greater than zero")
    return c


class _JointStateConstraint(ConstraintSet):
    """Shared machinery: per-node rows over a list of position Vars."""

    batched = True

    def __init__(self, targets, position_vars: Sequence[Var], coeffs,
                 name: str, n_rows_per_node: int, min_vars: int,
                 default_coeff: float):
        if len(position_vars) < min_vars:
            raise ValueError(
                f"{type(self).__name__} requires at least {min_vars} "
                f"position variables")
        targets = np.asarray(targets, float).reshape(-1)
        n_dof = targets.shape[0]
        for v in position_vars:
            if v.size != n_dof:
                raise ValueError(
                    f"{type(self).__name__}: var {v.name!r} size {v.size} "
                    f"!= targets size {n_dof}")
        self.n_dof = n_dof
        self.position_vars = list(position_vars)
        self.targets = targets
        self.coeffs = _broadcast_coeffs(coeffs, n_dof, default_coeff,
                                        type(self).__name__)
        self._c = Consts(coeffs=self.coeffs)
        n_nodes = n_rows_per_node
        tiled_t = np.tile(targets * self.coeffs, n_nodes)
        super().__init__(n_dof * n_nodes, name,
                         [Bounds(t, t) for t in tiled_t])

    def _q(self, vars: _VarReader):  # noqa: A002
        """[..., n_nodes, n_dof] positions of the nodes."""
        return torch.stack([v.value(vars.flat) for v in self.position_vars],
                           -2)

    def _scale(self, rows):
        rows = rows * self._c.get("coeffs", rows)
        return rows.reshape(*rows.shape[:-2], -1)


class JointPosConstraint(_JointStateConstraint):
    """Joint positions of each node equal the targets
    (joint_position_constraint.h; values = q_i, bounds = targets)."""

    def __init__(self, targets, position_vars: Sequence[Var], coeffs=None,
                 name: str = "JointPos"):
        super().__init__(targets, position_vars, coeffs, name,
                         n_rows_per_node=len(position_vars), min_vars=1,
                         default_coeff=1.0)

    def values(self, vars: _VarReader):  # noqa: A002
        return self._scale(self._q(vars))


class JointVelConstraint(_JointStateConstraint):
    """Per-segment backward-difference velocities equal the targets
    (joint_velocity_constraint.cpp:85-101: v_seg = q_{seg+1} - q_seg;
    default coeff 5 as in the reference)."""

    def __init__(self, targets, position_vars: Sequence[Var], coeffs=None,
                 name: str = "JointVel"):
        super().__init__(targets, position_vars, coeffs, name,
                         n_rows_per_node=len(position_vars) - 1, min_vars=2,
                         default_coeff=5.0)

    def values(self, vars: _VarReader):  # noqa: A002
        q = self._q(vars)
        return self._scale(q[..., 1:, :] - q[..., :-1, :])


class JointAccelConstraint(_JointStateConstraint):
    """Second differences per node, with the reference's backward-
    difference tail rows (joint_acceleration_constraint.cpp getValues:
    rows i < n-2 use q_{i+2} - 2 q_{i+1} + q_i; the last two rows use
    q_{i-2} - 2 q_{i-1} + q_i)."""

    def __init__(self, targets, position_vars: Sequence[Var], coeffs=None,
                 name: str = "JointAccel"):
        # the backward tail rows reach back to q_{n-4}
        super().__init__(targets, position_vars, coeffs, name,
                         n_rows_per_node=len(position_vars), min_vars=4,
                         default_coeff=1.0)

    def values(self, vars: _VarReader):  # noqa: A002
        q = self._q(vars)
        fwd = q[..., 2:, :] - 2.0 * q[..., 1:-1, :] + q[..., :-2, :]
        a_n2 = q[..., -4, :] - 2.0 * q[..., -3, :] + q[..., -2, :]
        a_n1 = q[..., -3, :] - 2.0 * q[..., -2, :] + q[..., -1, :]
        return self._scale(torch.cat([fwd, a_n2[..., None, :],
                                      a_n1[..., None, :]], -2))


class JointJerkConstraint(_JointStateConstraint):
    """Third differences per node with the reference's tail handling
    (joint_jerk_constraint.cpp getValues: rows i < n-3 use
    -q_i + 3 q_{i+1} - 3 q_{i+2} + q_{i+3}; the last three rows use
    q_i - 3 q_{i-1} + 3 q_{i-2} - q_{i-3})."""

    def __init__(self, targets, position_vars: Sequence[Var], coeffs=None,
                 name: str = "JointJerk"):
        # the backward tail rows reach back to q_{n-6}
        super().__init__(targets, position_vars, coeffs, name,
                         n_rows_per_node=len(position_vars), min_vars=6,
                         default_coeff=1.0)

    def values(self, vars: _VarReader):  # noqa: A002
        q = self._q(vars)
        n = q.shape[-2]
        fwd = -q[..., :-3, :] + 3.0 * q[..., 1:-2, :] \
            - 3.0 * q[..., 2:-1, :] + q[..., 3:, :]
        tails = [q[..., i, :] - 3.0 * q[..., i - 1, :]
                 + 3.0 * q[..., i - 2, :] - q[..., i - 3, :]
                 for i in range(n - 3, n)]
        return self._scale(torch.cat([fwd] + [t[..., None, :]
                                              for t in tails], -2))


class CartPosConstraint(ConstraintSet):
    """Pose of ``link`` (with ``tcp`` offset) equals ``target`` (with
    ``target_tcp`` offset): rows = coeff * calcTransformError[indices]
    (cartesian_position_constraint.cpp; zero-coeff rows are dropped by
    passing ``indices``)."""

    batched = True

    def __init__(self, tree: KinematicTree, link: str, position_var: Var,
                 target, *, tcp=None, target_tcp=None, coeffs=None,
                 indices: Sequence[int] | None = None,
                 bounds: "Bounds | Sequence[Bounds] | None" = None,
                 name: str | None = None):
        self.tree = tree
        self.link_id = tree.link_id(link)
        self.position_var = position_var
        self.idx = np.arange(6) if indices is None else \
            np.asarray(indices, int)
        self.coeffs = np.ones(len(self.idx)) if coeffs is None else \
            np.broadcast_to(np.asarray(coeffs, float), (len(self.idx),))
        self.R_t, self.p_t = _as_pose(target)
        self.R_tcp, self.p_tcp = _as_pose(tcp)
        self.R_ttcp, self.p_ttcp = _as_pose(target_tcp)
        self._c = Consts(idx=self.idx, coeffs=self.coeffs, R_t=self.R_t,
                         p_t=self.p_t, R_tcp=self.R_tcp, p_tcp=self.p_tcp,
                         R_ttcp=self.R_ttcp, p_ttcp=self.p_ttcp)
        super().__init__(len(self.idx), name or f"CartPos_{link}",
                         bounds if bounds is not None else Bounds(0.0, 0.0))

    def _source_pose(self, q):
        c = self._c
        R, p = self.tree.fk(q)
        return compose(R[..., self.link_id, :, :], p[..., self.link_id, :],
                       c.get("R_tcp", q), c.get("p_tcp", q))

    def _rows(self, e, q):
        """The error's selected rows, coefficient-scaled."""
        return e[..., self._c.get("idx", q)] * self._c.get("coeffs", q)

    def values(self, vars: _VarReader):  # noqa: A002
        q = self.position_var.value(vars.flat)
        c = self._c
        R_src, p_src = self._source_pose(q)
        R_t, p_t = compose(c.get("R_t", q), c.get("p_t", q),
                           c.get("R_ttcp", q), c.get("p_ttcp", q))
        return self._rows(transform_error(R_t, p_t, R_src, p_src), q)


class CartLineConstraint(CartPosConstraint):
    """Pose error to the nearest point on the segment between two target
    poses: position by clamped projection, orientation by slerp of the
    projection parameter (cartesian_line_constraint.cpp:119-149)."""

    def __init__(self, tree: KinematicTree, link: str, position_var: Var,
                 line_start, line_end, *, tcp=None, coeffs=None,
                 indices: Sequence[int] | None = None,
                 bounds: "Bounds | Sequence[Bounds] | None" = None,
                 name: str | None = None):
        super().__init__(tree, link, position_var, line_start, tcp=tcp,
                         coeffs=coeffs, indices=indices, bounds=bounds,
                         name=name or f"CartLine_{link}")
        self.R1, self.p1 = _as_pose(line_start)
        self.R2, self.p2 = _as_pose(line_end)
        self._line = Consts(R1=self.R1, R2=self.R2, p1=self.p1, p2=self.p2)

    def values(self, vars: _VarReader):  # noqa: A002
        q = self.position_var.value(vars.flat)
        c = self._line
        R_src, p_src = self._source_pose(q)
        p1, p2 = c.get("p1", q), c.get("p2", q)
        R1, R2 = c.get("R1", q), c.get("R2", q)
        ab = p2 - p1
        t = torch.clamp(((p_src - p1) * ab).sum(-1)
                        / ((ab * ab).sum() + 1e-12), 0.0, 1.0)
        p_line = p1 + t[..., None] * ab
        rv = rotvec_from_matrix(R1.transpose(-1, -2) @ R2)
        angle = torch.linalg.vector_norm(rv) + 1e-12
        R_line = R1 @ axis_angle_matrix(rv / angle, t * angle)
        return self._rows(transform_error(R_line, p_line, R_src, p_src), q)


class InverseKinematicsConstraint(ConstraintSet):
    """Joint values equal the IK solution of a target pose: rows =
    coeff * (q - ik(target, seed)) with equality-at-zero bounds
    (inverse_kinematics_constraint.cpp getValues; the IK solve runs once,
    at construction, in float64 on the CPU, like terms/cartesian.py
    ik_constraint)."""

    batched = True

    def __init__(self, tree: KinematicTree, link: str, position_var: Var,
                 target, q_seed, *, coeffs=None, pos_only: bool = False,
                 name: str | None = None):
        from trajopt_tpu_torch.kinematics.ik import solve_ik

        self.position_var = position_var
        R_t, p_t = _as_pose(target)
        q_ik, _ = solve_ik(tree, link, R_t, p_t,
                           torch.as_tensor(np.asarray(q_seed, float)),
                           pos_only=pos_only)
        self.q_ik = q_ik.numpy()
        n_dof = tree.n_dof
        self.coeffs = _broadcast_coeffs(coeffs, n_dof, 1.0,
                                        type(self).__name__)
        self._c = Consts(q_ik=self.q_ik, coeffs=self.coeffs)
        super().__init__(n_dof, name or f"IK_{link}", Bounds(0.0, 0.0))

    def values(self, vars: _VarReader):  # noqa: A002
        q = self.position_var.value(vars.flat)
        return (q - self._c.get("q_ik", q)) * self._c.get("coeffs", q)
