"""ifopt-style object-oriented component model over the functional core.

Counterpart of ``trajopt_tpu/ifopt/__init__.py``: the reference's new-stack
NLP component model -- the vendored ifopt fork in ``trajopt_ifopt/core``
(``Component``/``Variables``/``ConstraintSet``/``CostTerm``/``Problem``,
``core/problem.h:96``) and its variable sets (``Var``/``Node``/
``NodesVariables``, ``variable_sets/var.h:52-92``, ``node.h:50``,
``nodes_variables.h:46``) -- as a thin facade that *lowers* to
:class:`trajopt_tpu_torch.sqp.nlp.Nlp` term sets.  The reference's
``Composite`` aggregation machinery does not exist: :class:`Problem`
aggregates directly and the SQP consumes flat tensors.

Semantics kept from the reference:

* A ``ConstraintSet`` exposes rows with per-row interval ``Bounds``
  (kEquality / BoundSmallerZero / BoundGreaterZero / NoBound as in
  ``core/bounds.h``); lowering turns equality rows into CNT_EQ residuals
  and finite interval sides into CNT_INEQ rows.
* ``SquaredCost`` / ``AbsoluteCost`` wrap a constraint set into a cost on
  its *bounds violation* with per-row weights, like
  ``costs/squared_cost.cpp`` (cost = sum_i w_i e_i^2 with
  e = calcBoundsErrors) and ``costs/absolute_cost.cpp``.
* ``Problem`` stacks variable sets in insertion order; components read
  variable values by set name / Var handle.

The port's solver is batch-first: a lowered term takes ``x [B, n]``.  A
user's set (a ``FunctionalConstraint``'s callable, a subclass's ``values``
or ``cost``) sees one lane, ``x [n]``, as in the JAX package: it runs
under ``torch.func.vmap``, and its Jacobian, unless the set gives an
analytic ``jacobian``, is ``torch.func.jacrev`` of its values.  The typed
sets of ``constraints.py`` and ``collision.py`` are written on tensors
with leading axes (``batched = True``) and take the whole batch at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from trajopt_tpu_torch import resolve_device, resolve_dtype
from trajopt_tpu_torch.sqp.nlp import (Consts, Kind, Nlp, TermSet,
                                       library_code)
from trajopt_tpu_torch.sqp.params import SQPParams
from trajopt_tpu_torch.sqp.solver import SQPResult, make_solver
from trajopt_tpu_torch.utils import aot_cache, on_device

__all__ = [
    "Bounds", "BoundsEquality", "BoundSmallerZero", "BoundGreaterZero",
    "NoBound", "Var", "Node", "NodesVariables", "VariableSet",
    "ConstraintSet", "CostTerm", "SquaredCost", "AbsoluteCost", "Problem",
    "DiscreteCollisionConstraint", "ContinuousCollisionConstraint",
    "JointPosConstraint", "JointVelConstraint", "JointAccelConstraint",
    "JointJerkConstraint", "CartPosConstraint", "CartLineConstraint",
    "InverseKinematicsConstraint",
]


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Per-row interval bound (core/bounds.h)."""

    lower: float = -np.inf
    upper: float = np.inf

    @staticmethod
    def equality(v: float) -> "Bounds":
        return Bounds(v, v)


BoundsEquality = Bounds(0.0, 0.0)
BoundSmallerZero = Bounds(-np.inf, 0.0)
BoundGreaterZero = Bounds(0.0, np.inf)
NoBound = Bounds(-np.inf, np.inf)


@dataclasses.dataclass(frozen=True)
class Var:
    """A contiguous block of decision variables with a global start index
    (variable_sets/var.h:52-92)."""

    start: int
    size: int
    name: str = ""

    def value(self, x: torch.Tensor) -> torch.Tensor:
        """``x[..., start:start + size]`` of a flat vector or a batch."""
        return x[..., self.start:self.start + self.size]


class Node:
    """One timestep owning named Vars (variable_sets/node.h:50)."""

    def __init__(self, name: str = "node"):
        self.name = name
        self._specs: list[tuple[str, int]] = []

    def add_var(self, name: str, size: int) -> None:
        self._specs.append((name, size))

    @property
    def size(self) -> int:
        return sum(s for _, s in self._specs)


class VariableSet:
    """A named block of variables with bounds and initial values
    (ifopt ``Variables``)."""

    def __init__(self, name: str, init: np.ndarray,
                 lower: np.ndarray | float = -np.inf,
                 upper: np.ndarray | float = np.inf):
        self.name = name
        self.init = np.asarray(init, np.float64).reshape(-1)
        n = self.init.shape[0]
        self.lower = np.broadcast_to(np.asarray(lower, np.float64), (n,))
        self.upper = np.broadcast_to(np.asarray(upper, np.float64), (n,))
        self.start = 0  # assigned by Problem

    @property
    def size(self) -> int:
        return self.init.shape[0]

    def var(self) -> Var:
        return Var(self.start, self.size, self.name)


class NodesVariables(VariableSet):
    """Whole-trajectory variable set: one Node per timestep
    (variable_sets/nodes_variables.h:46-87)."""

    def __init__(self, name: str, nodes: Sequence[Node],
                 init: np.ndarray,
                 lower: np.ndarray | float = -np.inf,
                 upper: np.ndarray | float = np.inf):
        super().__init__(name, init, lower, upper)
        self.nodes = list(nodes)
        sizes = [nd.size for nd in self.nodes]
        if sum(sizes) != self.size:
            raise ValueError(
                f"nodes total {sum(sizes)} vars != init size {self.size}")
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])

    def node_var(self, node_idx: int, var_name: str) -> Var:
        nd = self.nodes[node_idx]
        off = int(self._offsets[node_idx])
        for nm, sz in nd._specs:
            if nm == var_name:
                return Var(self.start + off, sz,
                           f"{self.name}[{node_idx}].{nm}")
            off += sz
        raise KeyError(f"node {node_idx} has no var {var_name!r}")


class _VarReader:
    """Read-only view of the flat decision vector (one lane ``[n]`` or a
    batch ``[B, n]``) by set name / Var."""

    def __init__(self, x: torch.Tensor, sets: dict[str, VariableSet]):
        self._x = x
        self._sets = sets

    def get(self, key: "str | Var") -> torch.Tensor:
        if isinstance(key, Var):
            return key.value(self._x)
        vs = self._sets[key]
        return self._x[..., vs.start:vs.start + vs.size]

    __getitem__ = get

    @property
    def flat(self) -> torch.Tensor:
        return self._x


class ConstraintSet:
    """Rows g(x) with per-row interval bounds (core/constraint_set.h:92).

    Subclass and implement ``values(vars) -> [rows]``; optionally override
    ``jacobian(vars) -> [rows, n]`` (default: ``torch.func.jacrev`` of
    values).  ``bounds`` may be one Bounds (broadcast) or a per-row list.
    ``values`` sees one lane unless the class sets ``batched = True``: then
    it takes a reader over ``[..., n]`` and returns ``[..., rows]`` (and
    ``jacobian`` ``[..., rows, n]``).
    """

    batched = False

    def __init__(self, rows: int, name: str,
                 bounds: "Bounds | Sequence[Bounds]" = BoundsEquality):
        self.rows = rows
        self.name = name
        if isinstance(bounds, Bounds):
            bounds = [bounds] * rows
        if len(bounds) != rows:
            raise ValueError(f"{name}: {len(bounds)} bounds for {rows} rows")
        self.lower = np.asarray([b.lower for b in bounds], np.float64)
        self.upper = np.asarray([b.upper for b in bounds], np.float64)

    def values(self, vars: _VarReader) -> torch.Tensor:  # noqa: A002
        raise NotImplementedError

    jacobian: Callable | None = None

    def group_key(self):
        """Sets of one class whose keys are equal (and not None) are
        evaluated together by the class's ``group_values(sets, vars)`` /
        ``group_jacobian(sets, vars)``, which return one result per set
        (the collision constraints: one scene query for all of them)."""
        return None

    # -- reference utility: calcBoundsErrors (utils/ifopt_utils.h) --
    def bounds_errors(self, v: torch.Tensor) -> torch.Tensor:
        zero = v.new_zeros(())
        lo, hi = (on_device(a, "bounds", lambda a=a: a, v.device, v.dtype)
                  for a in (self.lower, self.upper))
        return torch.maximum(v - hi, zero) + torch.minimum(v - lo, zero)


class FunctionalConstraint(ConstraintSet):
    """ConstraintSet from a plain callable of one lane's reader
    (UserDefined analog)."""

    def __init__(self, rows: int, name: str, fn: Callable,
                 bounds: "Bounds | Sequence[Bounds]" = BoundsEquality):
        super().__init__(rows, name, bounds)
        self._fn = fn

    def values(self, vars: _VarReader) -> torch.Tensor:  # noqa: A002
        return self._fn(vars)


class CostTerm:
    """Scalar cost component (core/cost_term.h); ``cost`` sees one lane."""

    def __init__(self, name: str):
        self.name = name

    def cost(self, vars: _VarReader) -> torch.Tensor:  # noqa: A002
        raise NotImplementedError


class SquaredCost(CostTerm):
    """cost = sum_i w_i * e_i^2, e = bounds errors of the wrapped
    constraint (costs/squared_cost.cpp:31-38)."""

    def __init__(self, constraint: ConstraintSet,
                 weights: np.ndarray | float = 1.0):
        super().__init__(constraint.name + "_squared_cost")
        self.constraint = constraint
        self.weights = np.abs(np.broadcast_to(
            np.asarray(weights, np.float64), (constraint.rows,)))


class AbsoluteCost(CostTerm):
    """cost = sum_i w_i * |e_i| (costs/absolute_cost.cpp)."""

    def __init__(self, constraint: ConstraintSet,
                 weights: np.ndarray | float = 1.0):
        super().__init__(constraint.name + "_absolute_cost")
        self.constraint = constraint
        self.weights = np.abs(np.broadcast_to(
            np.asarray(weights, np.float64), (constraint.rows,)))


class Problem:
    """Stacks variable sets, sums costs, stacks constraint sets
    (core/problem.h:96); ``solve()`` lowers to the trust-region SQP."""

    def __init__(self):
        self._var_sets: list[VariableSet] = []
        self._by_name: dict[str, VariableSet] = {}
        self._cnt_sets: list[ConstraintSet] = []
        self._cost_sets: list[CostTerm] = []
        self._n = 0

    # -- construction --
    def add_variable_set(self, vs: VariableSet) -> VariableSet:
        if vs.name in self._by_name:
            raise ValueError(f"duplicate variable set {vs.name!r}")
        vs.start = self._n
        self._n += vs.size
        self._var_sets.append(vs)
        self._by_name[vs.name] = vs
        return vs

    def add_constraint_set(self, cs: ConstraintSet) -> ConstraintSet:
        self._cnt_sets.append(cs)
        return cs

    def add_cost_set(self, cost: CostTerm) -> CostTerm:
        self._cost_sets.append(cost)
        return cost

    @property
    def n(self) -> int:
        return self._n

    # -- lowering --
    @staticmethod
    def _user_code(cs: "ConstraintSet") -> bool:
        """Whether ``cs`` evaluates through a user's code: a user's class
        (a subclass's ``values``), an instance's own ``jacobian``, or a
        ``FunctionalConstraint``'s callable."""
        return not all(map(library_code, (type(cs), cs.jacobian,
                                          getattr(cs, "_fn", None))))

    def _groups(self) -> dict[int, "_Group"]:
        """The evaluation group of each grouped constraint set, by id."""
        by_key: dict = {}
        for cs in self._cnt_sets:
            key = cs.group_key()
            if key is not None:
                by_key.setdefault(key, []).append(cs)
        out = {}
        for sets in by_key.values():
            g = _Group(sets, dict(self._by_name))
            out.update((id(cs), g) for cs in sets)
        return out

    def _batch_fn(self, f, batched: bool):
        """``f(reader)`` as a function of ``x [B, n]``: called on the batch
        (``batched``) or on each lane under ``torch.func.vmap``."""
        sets = dict(self._by_name)
        if batched:
            return lambda x: f(_VarReader(x, sets))
        return torch.func.vmap(lambda xl: f(_VarReader(xl, sets)))

    def _lower_constraint(self, cs: ConstraintSet,
                          group: "_Group | None" = None) -> list[TermSet]:
        eq = (cs.lower == cs.upper)
        lo_fin = np.isfinite(cs.lower) & ~eq
        hi_fin = np.isfinite(cs.upper) & ~eq
        values = self._batch_fn(cs.values, cs.batched)
        # The analytic Jacobian when the set provides one (e.g. the
        # collision constraints' error-weighted-average gradients, which
        # autodiff of values() would NOT reproduce -- the reference pairs
        # calcValues with a hand-built Jacobian the same way,
        # discrete_collision_constraint.cpp:142-162).
        jac = (None if cs.jacobian is None
               else self._batch_fn(cs.jacobian, cs.batched))
        if group is not None:
            values = group.reader("group_values", cs, values)
            jac = group.reader("group_jacobian", cs, jac)
        out: list[TermSet] = []

        def part(suffix, kind, mask, bound, sign):
            idx = np.flatnonzero(mask)
            c = Consts(idx=idx, bound=bound[idx])

            def fn(x, params):
                v = values(x)[..., c.get("idx", x)]
                return v - c.get("bound", x) if sign > 0 \
                    else c.get("bound", x) - v

            def jac_fn(x, params):
                return sign * jac(x)[..., c.get("idx", x), :]

            out.append(TermSet(name=f"{cs.name}/{suffix}", kind=kind, fn=fn,
                               n_rows=int(mask.sum()),
                               jac_fn=None if jac is None else jac_fn,
                               user_code=self._user_code(cs)))

        if eq.any():
            part("eq", Kind.CNT_EQ, eq, cs.lower, 1.0)
        if hi_fin.any():
            part("ub", Kind.CNT_INEQ, hi_fin, cs.upper, 1.0)
        if lo_fin.any():
            part("lb", Kind.CNT_INEQ, lo_fin, cs.lower, -1.0)
        return out

    def _lower_cost(self, cost: CostTerm) -> TermSet:
        if isinstance(cost, (SquaredCost, AbsoluteCost)):
            cs = cost.constraint
            w = cost.weights
            values = self._batch_fn(cs.values, cs.batched)
            kind = (Kind.COST_SQ if isinstance(cost, SquaredCost)
                    else Kind.COST_ABS)
            return TermSet(name=cost.name, kind=kind,
                           fn=lambda x, p: cs.bounds_errors(values(x)),
                           n_rows=cs.rows, weight_fn=lambda p: w,
                           user_code=self._user_code(cs))
        value = self._batch_fn(cost.cost, False)
        return TermSet(name=cost.name, kind=Kind.COST_GENERIC_FULL,
                       fn=lambda x, p: value(x).reshape(x.shape[0], 1),
                       n_rows=1, user_code=not library_code(type(cost)))

    def build(self) -> Nlp:
        terms: list[TermSet] = []
        for cost in self._cost_sets:
            terms.append(self._lower_cost(cost))
        groups = self._groups()
        for cs in self._cnt_sets:
            terms.extend(self._lower_constraint(cs, groups.get(id(cs))))
        return Nlp(n=self._n, term_sets=tuple(terms))

    def initial_values(self) -> np.ndarray:
        return np.concatenate([vs.init for vs in self._var_sets]) \
            if self._var_sets else np.zeros(0)

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        lo = np.concatenate([vs.lower for vs in self._var_sets]) \
            if self._var_sets else np.zeros(0)
        hi = np.concatenate([vs.upper for vs in self._var_sets]) \
            if self._var_sets else np.zeros(0)
        return lo, hi

    def solve(self, sqp: SQPParams = SQPParams(), x0=None, params=None,
              dtype=None, device=None):
        """Lower and solve ``x0 [n]`` (default: the initial values) as one
        lane on ``device`` (None: CUDA, raising when there is none; float32
        there, float64 on the CPU unless ``dtype`` says otherwise).
        ``params`` are the lane's entries, without the lane axis.  Returns
        (result without the lane axis, values by set name as numpy)."""
        solver = make_solver(self.build(), sqp=sqp)
        dev = resolve_device(device)
        dtype = resolve_dtype(dev, dtype)
        x0 = self.initial_values() if x0 is None else x0
        kw = dict(dtype=dtype, device=dev)
        lo, hi = (torch.as_tensor(b, **kw)[None] for b in self.bounds())
        p = {k: torch.as_tensor(v, **kw)[None]
             for k, v in (params or {}).items()}
        res = solver(torch.as_tensor(np.asarray(x0), **kw)[None], lo, hi, p)
        res = SQPResult(*(f[0] for f in res))
        x = res.x.detach().cpu().numpy()
        values = {vs.name: x[vs.start:vs.start + vs.size]
                  for vs in self._var_sets}
        return res, values


class _Group:
    """Constraint sets evaluated together: the first member's term to see a
    batch ``x`` runs the class's group method once for all members, and
    every member reads its own result until a different ``x`` (or an
    in-place change of it, or the start of a warm-up or capture of a
    ``utils/aot_cache.py`` region) comes.  Under ``torch.func`` transforms
    each set is evaluated alone.  The epoch check keeps a capture from
    reading a result of its warm-up, which holds the same input tensor:
    the graph would then replay without the group's evaluation."""

    def __init__(self, sets: list[ConstraintSet], var_sets: dict):
        self.sets = sets
        self._var_sets = var_sets
        self._memo: dict[str, tuple] = {}

    def reader(self, method: str, cs: ConstraintSet, alone):
        """``fn(x)``: set ``cs``'s share of ``method`` at ``x`` (``alone(x)``
        under a transform)."""
        def fn(x):
            if torch._C._functorch.is_functorch_wrapped_tensor(x):
                return alone(x)
            hit = self._memo.get(method)
            epoch = aot_cache.capture_epoch()
            if hit is None or hit[0] is not x or hit[1] != x._version \
                    or hit[2] != epoch:
                out = getattr(type(cs), method)(
                    self.sets, _VarReader(x, self._var_sets))
                hit = (x, x._version, epoch,
                       dict(zip(map(id, self.sets), out)))
                self._memo[method] = hit
            return hit[3][id(cs)]
        return fn


# Typed constraint sets import from this module, so they load last.
from trajopt_tpu_torch.ifopt.collision import (  # noqa: E402
    ContinuousCollisionConstraint, DiscreteCollisionConstraint)
from trajopt_tpu_torch.ifopt.constraints import (  # noqa: E402
    CartLineConstraint, CartPosConstraint, InverseKinematicsConstraint,
    JointAccelConstraint, JointJerkConstraint, JointPosConstraint,
    JointVelConstraint)
