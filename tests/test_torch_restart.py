"""Port parity for the SQP driver's restarts: the second-chance restart in
place, the multi-start family (``params["restart_inits"]``) and the
saturated-dual rescale (``rescale_duals_on_escalation``), against the JAX
package in float64 on the CPU.

The problems are the tiny ``Nlp``s of ``tests/test_robustness.py``, each
solved on the dense QP path and on the block-banded one (the same term
sets with banded Jacobians and a (T, D) layout), a few lanes at once; the
JAX reference is one ``jit(vmap(solve))`` per case.  Each case asserts on
the JAX side that its feature fired (a restart, a re-seed, an
escalation), then holds the port to it: equal status, ``n_iter``,
``n_qp_solves`` and ``n_func_evals``, and x within 1e-9 (the same float64
arithmetic with products summed in another order; measured 1.4e-14 at
most).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.sqp import nlp as jnlp
from trajopt_tpu.sqp.params import SQPParams as JaxSQPParams
from trajopt_tpu.sqp.solver import make_solver as jax_make_solver
from trajopt_tpu_torch.sqp import nlp as tnlp
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.solver import make_solver

torch.set_num_threads(2)

INF = float("inf")
XTOL = 1e-9
PATHS = ("dense", "block")


def _problem(name: str, mod):
    """(Nlp, n) of one tiny problem for ``mod`` = jnlp or tnlp.  JAX terms
    map one problem x [n] -> [rows]; the port's map a batch [B, n] ->
    [B, rows].  Constraint sets carry banded Jacobians (one row covering
    the whole of x) so the same Nlp runs the block path."""
    jax_side = mod is jnlp
    K = mod.Kind

    def band(jac):
        if jax_side:
            return lambda x, p: jac(x)[None, :]
        return lambda x, p: jac(x)[:, None, :]

    def cnt(name_, kind, fn, jac, n):
        return mod.TermSet(name_, kind, fn, 1, banded_jac=band(jac),
                           band_starts=np.array([0]), band_width=n)

    if name == "pull_goal":
        # strong cost pulls x to 0; the constraint wants x = 1
        sets = (mod.TermSet("pull", K.COST_SQ, lambda x, p: 100.0 * x, 1),
                cnt("goal", K.CNT_EQ, lambda x, p: x - 1.0,
                    lambda x: x * 0.0 + 1.0, 1))
        n = 1
    elif name == "ring":
        # 1 - x^2 <= 0 has zero gradient at x = 0: every linearization
        # there is the unimprovable row 1 <= 0
        sets = (mod.TermSet("center", K.COST_SQ, lambda x, p: 0.1 * x, 1),
                cnt("ring", K.CNT_INEQ, lambda x, p: 1.0 - x * x,
                    lambda x: -2.0 * x, 1))
        n = 1
    else:                                  # "sum": needs escalation
        if jax_side:
            def total(x, p):
                return jnp.atleast_1d(x[0] + x[1] - 2.0)
        else:
            def total(x, p):
                return x[:, :1] + x[:, 1:2] - 2.0
        sets = (mod.TermSet("pull", K.COST_SQ, lambda x, p: 3.0 * x, 2),
                cnt("sum", K.CNT_EQ, total, lambda x: x * 0.0 + 1.0, 2))
        n = 2
    return mod.Nlp(n=n, term_sets=sets, block=(1, n)), n


# (problem, SQPParams fields, initial x per lane, family rows per lane or
# None, what must fire on the JAX side)
CASES = {
    "in_place_restart": ("pull_goal", dict(
        initial_merit_error_coeff=1e-6, max_merit_coeff_increases=2,
        max_restarts=1, restart_merit_coeff=1e6), [[0.0], [0.5]], None,
        "restart"),
    "trap_in_place": ("ring", dict(max_restarts=1), [[0.0], [2.0]], None,
                      "trapped"),
    "trap_family": ("ring", dict(max_restarts=1), [[0.0], [2.0]],
                    [[[0.5]], [[0.5]]], "reseed"),
    "last_rows_rule": ("ring", dict(max_restarts=2), [[0.0], [0.0]],
                       [[[-0.5]], [[0.7]]], "reseed"),
    "rescale_duals": ("sum", dict(initial_merit_error_coeff=0.1,
                                  rescale_duals_on_escalation=True),
                      [[0.0, 0.0], [0.5, -0.3]], None, "escalation"),
}


def _jax_solve(case, path):
    name, fields, x0, family, _ = CASES[case]
    nlp, n = _problem(name, jnlp)
    solve = jax_make_solver(nlp, sqp=dataclasses.replace(JaxSQPParams(),
                                                         **fields),
                            structured=(path == "block"))
    lo, hi = jnp.full(n, -INF), jnp.full(n, INF)
    x0 = jnp.asarray(x0, jnp.float64)
    if family is None:
        res = jax.jit(jax.vmap(lambda x: solve(x, lo, hi, {})))(x0)
    else:
        res = jax.jit(jax.vmap(lambda x, r: solve(
            x, lo, hi, {"restart_inits": r})))(x0, jnp.asarray(family))
    return jax.tree.map(np.asarray, res)


def _port_solve(case, path, with_family=True):
    name, fields, x0, family, _ = CASES[case]
    nlp, n = _problem(name, tnlp)
    solve = make_solver(nlp, dataclasses.replace(SQPParams(), **fields),
                        structured=(path == "block"))
    x0 = torch.as_tensor(x0, dtype=torch.float64)
    lo, hi = torch.full_like(x0, -INF), torch.full_like(x0, INF)
    params = {}
    if family is not None and with_family:
        params["restart_inits"] = torch.as_tensor(family, dtype=torch.float64)
    return solve(x0, lo, hi, params)


def _assert_same(res, ref):
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_array_equal(res.n_func_evals.numpy(),
                                  ref.n_func_evals)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=XTOL)
    np.testing.assert_allclose(res.merit_coeffs.numpy(), ref.merit_coeffs,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_restarts_match_jax(case, path):
    ref = _jax_solve(case, path)
    res = _port_solve(case, path)
    _assert_same(res, ref)
    fired = CASES[case][4]
    conv = SQPStatus.CONVERGED
    if fired == "restart":
        # lane 0 exhausts its escalations, restarts at 1e6 and converges
        assert ref.status[0] == conv and abs(ref.x[0, 0] - 1.0) < 1e-3
        assert ref.merit_coeffs[0, 0] == 1e6
    elif fired == "trapped":
        # the in-place restart cannot leave the zero-gradient point
        assert ref.status[0] == SQPStatus.PENALTY_ITERATION_LIMIT
        assert ref.status[1] == conv
    elif fired == "reseed":
        # a re-seeded lane counts one evaluation per QP solve, plus the
        # initial one and one for the re-seed
        assert ref.status[0] == conv
        assert ref.n_func_evals[0] == ref.n_qp_solves[0] + 2
        assert np.abs(ref.x[0]).min() >= 1.0 - 1e-3
        if case == "last_rows_rule":
            # restart 0 in place, restart 1 from the row -0.5: the
            # negative branch of the ring, |x| >= 1
            assert ref.x[0, 0] < -0.99
            assert ref.x[1, 0] > 0.99
    else:
        assert (ref.status == conv).all()
        assert (ref.merit_coeffs > 0.1).all()        # escalated


@pytest.mark.parametrize("path", PATHS)
def test_family_absent_or_unused_changes_nothing(path):
    """A lane that never restarts gives bit-identical results with and
    without the family; a restarted lane without it stays trapped."""
    with_fam = _port_solve("trap_family", path)
    without = _port_solve("trap_family", path, with_family=False)
    for a, b in zip(with_fam, without):
        assert torch.equal(a[1], b[1])
    assert int(with_fam.status[0]) == SQPStatus.CONVERGED
    assert int(without.status[0]) == SQPStatus.PENALTY_ITERATION_LIMIT


def test_family_stays_out_of_the_terms():
    """restart_inits is solver input: the term functions never see it."""
    seen = []

    def ring(x, p):
        seen.append(sorted(p))
        return 1.0 - x * x

    nlp = tnlp.Nlp(n=1, term_sets=(
        tnlp.TermSet("center", tnlp.Kind.COST_SQ, lambda x, p: 0.1 * x, 1),
        tnlp.TermSet("ring", tnlp.Kind.CNT_INEQ, ring, 1)))
    solve = make_solver(nlp, SQPParams(max_restarts=1))
    x0 = torch.zeros(2, 1, dtype=torch.float64)
    res = solve(x0, x0 - INF, x0 + INF,
                {"restart_inits": torch.full((2, 1, 1), 0.5,
                                             dtype=torch.float64),
                 "tag": torch.zeros(2)})
    assert (res.status == SQPStatus.CONVERGED).all()
    assert seen and all(keys == ["tag"] for keys in seen)
