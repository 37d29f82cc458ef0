"""Facade collision constraints for the ifopt component model.

Counterpart of ``trajopt_tpu/ifopt/collision.py``: the reference's
fixed-size collision constraints
(``trajopt_ifopt/src/constraints/collision/discrete_collision_constraint
.cpp:60-272`` and ``continuous_collision_constraint.cpp``): rows are LINK
pairs, pinned to ``max_num_cnt`` (``TrajOptCollisionConfig``,
``collision_types.h:156-162``, default 3); each row's VALUE is the worst
member error ``coeff * (margin - d)`` over the link pair's contact set,
and its JACOBIAN is the error-weighted average of the member gradients
(``weighted_average_methods.cpp:31-108``) -- autodiff of the row value
would give the argmax member's gradient instead, so these sets carry an
analytic ``jacobian`` and the facade lowering wires it through.

The continuous variant casts between two adjacent position variables with
optional LVS sub-segmentation: contacts from every sub-segment merge into
the link pair's set before aggregation, like
``LVSContinuousCollisionEvaluator`` merging sub-state results into one
``GradientResultsSet``.

The link-pair aggregation and the top-k are the collision term's
(``terms/collision.py`` ``_Rows``: ``scatter_reduce(..., "amax")`` and
``index_add`` for the JAX package's ``segment_max`` / ``segment_sum``, a
stable descending sort for ``lax.top_k``, so equal rows keep the lower
link pair first, as in JAX).  Sets of one class on one scene with equal
settings form a group (``group_key``): ``Problem`` evaluates a group with
one scene query for the whole batch, all its sets and all their LVS
sub-segments, and each set reads its own rows from it.
"""

from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.ifopt import BoundSmallerZero, ConstraintSet, Var
from trajopt_tpu_torch.sqp.nlp import Consts
from trajopt_tpu_torch.terms.collision import _Rows

__all__ = ["DiscreteCollisionConstraint", "ContinuousCollisionConstraint"]


class _CollisionConstraintBase(ConstraintSet):
    batched = True

    def __init__(self, scene: CollisionScene, margin: float, coeff: float,
                 max_num_cnt: int | None, safety_margin_buffer: float,
                 name: str):
        self._sel = _Rows(scene, "weighted_average", safety_margin_buffer,
                          max_num_cnt)
        super().__init__(self._sel.k, name, BoundSmallerZero)
        self.scene = scene
        self.margin = float(margin)
        self.coeff = float(coeff)
        self.buffer = float(safety_margin_buffer)

    def group_key(self):
        return (type(self), id(self.scene), self.margin, self.coeff,
                self.rows, self.buffer)

    def values(self, vars):  # noqa: A002
        return self.group_values([self], vars)[0]

    def jacobian(self, vars):  # noqa: A002
        return self.group_jacobian([self], vars)[0]

    def _err(self, d):
        return self.coeff * (self.margin - d)

    def _jac_rows(self, x, blocks):
        """[..., rows, n] with each (Var, [..., rows, n_dof]) block written
        into its variable's columns (later blocks win where they meet)."""
        out = x.new_zeros(*x.shape[:-1], self.rows, x.shape[-1])
        for var, J in blocks:
            out[..., var.start:var.start + var.size] = J.to(x.dtype)
        return out


class DiscreteCollisionConstraint(_CollisionConstraintBase):
    """Fixed-size discrete collision constraint on ONE position variable
    (discrete_collision_constraint.cpp:60-272): rows <= max_num_cnt link
    pairs with value coeff*(margin - d_worst) <= 0 and error-weighted-
    average analytic Jacobians."""

    def __init__(self, scene: CollisionScene, position_var: Var, *,
                 margin: float = 0.025, coeff: float = 20.0,
                 max_num_cnt: int | None = 3,
                 safety_margin_buffer: float = 0.0,
                 name: str = "discrete_collision"):
        super().__init__(scene, margin, coeff, max_num_cnt,
                         safety_margin_buffer, name)
        self._var = position_var

    @staticmethod
    def group_values(sets, vars):  # noqa: A002
        """Each set's rows [..., rows] from one query over all the sets'
        variables."""
        s = sets[0]
        q = torch.stack([vars[c._var] for c in sets], -2)    # [..., G, D]
        d = s.scene.distances(s.scene.tree.fk(q))
        return list(s._sel.values(s._err(d)).unbind(-2))

    @staticmethod
    def group_jacobian(sets, vars):  # noqa: A002
        s = sets[0]
        q = torch.stack([vars[c._var] for c in sets], -2)
        d, J = s.scene.distances_and_jac(s.scene.tree.fk_with_axes(q))
        _, (Jrows,) = s._sel.select(s._err(d), s.coeff, -s.coeff * J)
        return [c._jac_rows(vars.flat, [(c._var, Jrows[..., g, :, :])])
                for g, c in enumerate(sets)]


class ContinuousCollisionConstraint(_CollisionConstraintBase):
    """Fixed-size continuous (cast/swept) collision constraint between TWO
    adjacent position variables (continuous_collision_constraint.cpp):
    sub-segment contact sets merge per link pair before the weighted-
    average aggregation (the LVSContinuousCollisionEvaluator role)."""

    def __init__(self, scene: CollisionScene, position_var0: Var,
                 position_var1: Var, *, margin: float = 0.025,
                 coeff: float = 20.0, max_num_cnt: int | None = 3,
                 lvs_substeps: int = 1, safety_margin_buffer: float = 0.0,
                 name: str = "continuous_collision"):
        super().__init__(scene, margin, coeff, max_num_cnt,
                         safety_margin_buffer, name)
        self._var0 = position_var0
        self._var1 = position_var1
        self.lvs_substeps = int(lvs_substeps)
        fr = np.linspace(0.0, 1.0, self.lvs_substeps + 1)
        self._fr = Consts(all=fr, a=fr[:-1, None, None], b=fr[1:, None, None])

    def group_key(self):
        return super().group_key() + (self.lvs_substeps,)

    @staticmethod
    def _interp(sets, vars):  # noqa: A002
        """[..., G, n_sub + 1, n_dof]: q0 + f (q1 - q0) at the sub-segment
        ends of each set's gap."""
        q0 = torch.stack([vars[c._var0] for c in sets], -2)
        q1 = torch.stack([vars[c._var1] for c in sets], -2)
        fr = sets[0]._fr.get("all", q0)
        return q0[..., None, :] + fr[:, None] * (q1 - q0)[..., None, :]

    @staticmethod
    def group_values(sets, vars):  # noqa: A002
        s = sets[0]
        R, p = s.scene.tree.fk(s._interp(sets, vars))
        d_s = s.scene.swept_distances(
            (R[..., :-1, :, :, :], p[..., :-1, :, :]),
            (R[..., 1:, :, :, :], p[..., 1:, :, :]))   # [..., G, n_sub, P]
        d = torch.amin(d_s, -2)                        # merge sub-segments
        return list(s._sel.values(s._err(d)).unbind(-2))

    @staticmethod
    def group_jacobian(sets, vars):  # noqa: A002
        s = sets[0]
        fk = s.scene.tree.fk_with_axes(s._interp(sets, vars))
        first = tuple(t[..., :-1, :, :] for t in fk[2:])
        last = tuple(t[..., 1:, :, :] for t in fk[2:])
        d_s, Ja, Jb = s.scene.swept_distances_and_jac(
            (fk[0][..., :-1, :, :, :], fk[1][..., :-1, :, :], *first),
            (fk[0][..., 1:, :, :, :], fk[1][..., 1:, :, :], *last))
        # chain through the affine interpolation endpoints
        a, b = s._fr.get("a", d_s), s._fr.get("b", d_s)
        J0_s = (1.0 - a) * Ja + (1.0 - b) * Jb     # [..., G, n_sub, P, D]
        J1_s = a * Ja + b * Jb
        # per-pair worst sub-segment carries the contact (merged set)
        k = torch.argmin(d_s, -2, keepdim=True)    # [..., G, 1, P]
        d = torch.gather(d_s, -2, k)[..., 0, :]
        kj = k[..., None].expand(*k.shape, Ja.shape[-1])

        def take(J):
            return torch.gather(J, -3, kj)[..., 0, :, :]

        _, (R0, R1) = s._sel.select(s._err(d), s.coeff,
                                    -s.coeff * take(J0_s),
                                    -s.coeff * take(J1_s))
        return [c._jac_rows(vars.flat, [(c._var0, R0[..., g, :, :]),
                                        (c._var1, R1[..., g, :, :])])
                for g, c in enumerate(sets)]
