"""User-defined terms: arbitrary per-timestep error functions as costs or
constraints (UserDefinedTermInfo), on batched trajectories.

Counterpart of ``trajopt_tpu/terms/user.py``.  The user's error function
is a torch function of one configuration, ``err(q [n_dof], params) -> [m]``
(``params``: the lane's entries, without the batch axis); it runs on every
(lane, selected step) under ``torch.func.vmap``.  The Jacobian is the
user's ``jac(q, params) -> [m, n_dof]`` when given, else
``torch.func.jacfwd`` of the error function.

The JSON front end resolves the ``user_defined`` term type's
``error_function`` / ``jacobian_function`` names in
:data:`USER_FUNCTIONS` (register with :func:`register_user_function`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from trajopt_tpu_torch.sqp.nlp import Consts, Kind, TermSet, banded_to_dense

# name -> callable registry for the JSON hatch
USER_FUNCTIONS: dict[str, Callable] = {}


def register_user_function(name: str):
    """Decorator: register an error/jacobian function for JSON resolution."""

    def deco(fn: Callable):
        USER_FUNCTIONS[name] = fn
        return fn

    return deco


_PENALTY_KINDS = {"squared": Kind.COST_SQ, "abs": Kind.COST_ABS,
                  "hinge": Kind.COST_HINGE}
_CNT_KINDS = {"eq": Kind.CNT_EQ, "ineq": Kind.CNT_INEQ}


def user_defined_term(error_fn: Callable, n_steps: int, n_dof: int, *,
                      jac_fn: Callable | None = None, is_cost: bool = True,
                      penalty_type: str = "squared",
                      constraint_type: str = "eq", coeffs=None,
                      first_step: int = 0, last_step: int = -1,
                      fixed_steps: Sequence[int] = (),
                      n_dof_total: int | None = None,
                      name: str | None = None) -> TermSet:
    """Hatch ``error_fn(q_t, params)`` over the selected timesteps
    (UserDefinedTermInfo::hatch).  The row count is probed once, on zeros
    with empty params; ``coeffs`` scales the rows (constraint) or weights
    them (cost)."""
    n_dof_total = n_dof_total or n_dof
    if last_step <= -1:
        last_step = n_steps - 1
    steps = np.asarray([t for t in range(first_step, last_step + 1)
                        if t not in fixed_steps], np.int64)
    S = len(steps)
    if S == 0:
        raise ValueError("user_defined term selects no free timesteps")
    name = name or "user_defined"
    m = int(torch.atleast_1d(torch.as_tensor(error_fn(
        torch.zeros(n_dof, dtype=torch.float64), {}))).numel())
    cfs = np.ones(m) if coeffs is None else np.broadcast_to(
        np.asarray(coeffs, float).reshape(-1), (m,)).copy()
    consts = Consts(steps=steps, cfs=cfs)
    band_starts = np.repeat(steps * n_dof_total, m)
    n = n_steps * n_dof_total

    def rows_q(q, params):
        r = torch.atleast_1d(error_fn(q, params)).reshape(-1)
        return r if is_cost else r * consts.get("cfs", q)

    def _per_step(f, x, params):
        """f(q, lane params) on every (lane, step): [B, S, ...]."""
        qs = x.reshape(x.shape[0], n_steps, n_dof_total)[..., :n_dof]
        qs = qs[:, consts.get("steps", x)]

        def lane(q_l, p_l):
            return torch.func.vmap(lambda q: f(q, p_l))(q_l)
        return torch.func.vmap(lane)(qs, params)

    def fn(x, params):
        return _per_step(rows_q, x, params).reshape(x.shape[0], -1)

    def banded_jac(x, params):
        if jac_fn is not None:
            J = _per_step(lambda q, p: torch.as_tensor(jac_fn(q, p)), x,
                          params)
            if not is_cost:
                J = J * consts.get("cfs", x)[:, None]
        else:
            J = _per_step(torch.func.jacfwd(rows_q), x, params)
        W = x.new_zeros(x.shape[0], S * m, n_dof_total)
        W[..., :n_dof] = J.reshape(x.shape[0], S * m, n_dof)
        return W

    if is_cost:
        if penalty_type not in _PENALTY_KINDS:
            raise ValueError(f"penalty_type must be one of "
                             f"{sorted(_PENALTY_KINDS)}")
        kind = _PENALTY_KINDS[penalty_type]
        weight = lambda p: np.tile(cfs, S)  # noqa: E731
    else:
        if constraint_type not in _CNT_KINDS:
            raise ValueError(f"constraint_type must be one of "
                             f"{sorted(_CNT_KINDS)}")
        kind = _CNT_KINDS[constraint_type]
        weight = lambda p: 1.0  # noqa: E731

    return TermSet(name, kind, fn, S * m, weight_fn=weight,
                   jac_fn=lambda x, p: banded_to_dense(banded_jac(x, p),
                                                       band_starts, n),
                   banded_jac=banded_jac, band_starts=band_starts,
                   band_width=n_dof_total, user_code=True)
