"""Port parity: user-defined terms (``terms/user.py``) and the generic
costs of the NLP layer (``COST_GENERIC_FULL`` / ``COST_GENERIC_DIAG`` with
``_psd_project``, ``sqp/nlp.py``) against the JAX package, float64 on the
CPU.

* ``user_defined_term`` with autodiff Jacobians and with a user Jacobian
  function, as cost (each penalty type) and constraint (each constraint
  type), selected and fixed steps: rows, weights, dense and banded
  Jacobians to 1e-9.  The same error function is written once with
  ``jax.numpy`` and once with ``torch``;
* ``_psd_project`` on seeded symmetric matrices with negative eigenvalues;
* ``convexify`` of a problem with both generic kinds beside a squared
  cost: every ``ConvexModel`` field, the per-set model and exact costs and
  the model total, to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.sqp import nlp as jnlp
from trajopt_tpu.terms import user as juser
from trajopt_tpu_torch.sqp import nlp as tnlp
from trajopt_tpu_torch.terms import user as tuser

torch.set_num_threads(2)

TOL = 1e-9
N_STEPS, N_DOF = 5, 3


def err_jax(q, params):
    return jnp.stack([jnp.sin(q[0]) * q[1] - 0.3,
                      q[2] ** 2 + jnp.cos(q[0] + q[2]) - 1.0])


def err_torch(q, params):
    return torch.stack([torch.sin(q[0]) * q[1] - 0.3,
                        q[2] ** 2 + torch.cos(q[0] + q[2]) - 1.0])


def jac_jax(q, params):
    c = jnp.cos(q[0])
    s = -jnp.sin(q[0] + q[2])
    z = jnp.zeros_like(q[0])
    return jnp.stack([jnp.stack([c * q[1], jnp.sin(q[0]), z]),
                      jnp.stack([s, z, 2 * q[2] + s])])


def jac_torch(q, params):
    c = torch.cos(q[0])
    s = -torch.sin(q[0] + q[2])
    z = torch.zeros_like(q[0])
    return torch.stack([torch.stack([c * q[1], torch.sin(q[0]), z]),
                        torch.stack([s, z, 2 * q[2] + s])])


CASES = {
    "cost_sq_autodiff": (False, dict(is_cost=True, coeffs=[2.0, 0.5])),
    "cost_abs_jac": (True, dict(is_cost=True, penalty_type="abs",
                                first_step=1)),
    "cost_hinge_autodiff": (False, dict(is_cost=True, penalty_type="hinge",
                                        coeffs=3.0, last_step=3)),
    "cnt_eq_jac": (True, dict(is_cost=False, coeffs=[1.0, 4.0],
                              fixed_steps=[0])),
    "cnt_ineq_autodiff": (False, dict(is_cost=False, constraint_type="ineq",
                                      coeffs=2.0, fixed_steps=[0, 4])),
}


def _x(seed, B=3, n_dof_total=N_DOF):
    return np.random.default_rng(seed).standard_normal(
        (B, N_STEPS * n_dof_total))


@pytest.mark.parametrize("case", list(CASES))
def test_user_defined_term_matches_jax(case):
    with_jac, kw = CASES[case]
    jt = juser.user_defined_term(err_jax, N_STEPS, N_DOF,
                                 jac_fn=jac_jax if with_jac else None, **kw)
    tt = tuser.user_defined_term(err_torch, N_STEPS, N_DOF,
                                 jac_fn=jac_torch if with_jac else None, **kw)
    assert (tt.kind.value, tt.n_rows, tt.band_width) == \
        (jt.kind.value, jt.n_rows, jt.band_width)
    np.testing.assert_array_equal(tt.band_starts, jt.band_starts)
    x = _x(1)
    r_j, J_j, W_j, w_j = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda v: (jt.fn(v, {}), jt.jac_fn(v, {}), jt.banded_jac(v, {}),
                   jnp.broadcast_to(jt.weight_fn({}), (jt.n_rows,)))))(
        jnp.asarray(x)))
    # the user Jacobian is the error function's own
    J_ad = np.asarray(jax.vmap(jax.jacrev(lambda v: jt.fn(v, {})))(
        jnp.asarray(x)))
    np.testing.assert_allclose(J_j, J_ad, rtol=0, atol=1e-12)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(tt.fn(xt, {}).numpy(), r_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tt.jac_fn(xt, {}).numpy(), J_j, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tt.banded_jac(xt, {}).numpy(), W_j, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tnlp._weights(tt, {}, xt).numpy(), w_j,
                               rtol=0, atol=TOL)


def test_user_function_registry():
    tuser.register_user_function("sum_to_one")(
        lambda q, p: torch.atleast_1d(q.sum() - 1.0))
    t = tuser.user_defined_term(tuser.USER_FUNCTIONS["sum_to_one"], 2, 2,
                                is_cost=False)
    assert t.n_rows == 2
    with pytest.raises(ValueError, match="no free timesteps"):
        tuser.user_defined_term(err_torch, 2, 3, fixed_steps=[0, 1])
    with pytest.raises(ValueError, match="penalty_type"):
        tuser.user_defined_term(err_torch, 2, 3, penalty_type="cubic")


def test_psd_project_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 6, 6))
    H = A + A.transpose(0, 2, 1)
    assert np.linalg.eigvalsh(H).min() < 0
    ref = np.asarray(jax.vmap(jnlp._psd_project)(jnp.asarray(H)))
    got = tnlp._psd_project(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.linalg.eigvalsh(got).min() > -1e-12


def _generic_nlp(mod, Kind, TermSet, xp):
    """n = 6: a nonconvex generic cost of each kind (weights 2 and 0.5)
    between two squared-cost sets, so the per-set order is exercised."""
    n = 6

    def f_full(v, p):
        f = (xp.sin(v[..., 0]) * v[..., 1] + xp.cos(v[..., 2] * v[..., 3])
             - 0.3 * v[..., 4] ** 3 * v[..., 5])
        return f[..., None] if xp is torch else jnp.atleast_1d(f)

    def f_diag(x, p):
        if xp is torch:
            return (torch.sin(x) * x.roll(1, -1)).sum(-1, keepdim=True)
        return jnp.atleast_1d(jnp.sum(jnp.sin(x) * jnp.roll(x, 1)))

    def sq(x, p):
        return x[..., :3] - 0.5

    def sq2(x, p):
        return x[..., 3:] * 2.0

    return mod.Nlp(n=n, term_sets=(
        TermSet("sq", Kind.COST_SQ, sq, 3, weight_fn=lambda p: 1.5),
        TermSet("full", Kind.COST_GENERIC_FULL, f_full, 1,
                weight_fn=lambda p: 2.0),
        TermSet("diag", Kind.COST_GENERIC_DIAG, f_diag, 1,
                weight_fn=lambda p: 0.5),
        TermSet("sq2", Kind.COST_SQ, sq2, 3)))


def test_generic_cost_convexify_matches_jax():
    jn = _generic_nlp(jnlp, jnlp.Kind, jnlp.TermSet, jnp)
    tn = _generic_nlp(tnlp, tnlp.Kind, tnlp.TermSet, torch)
    x = 1.5 * np.random.default_rng(3).standard_normal((3, 6))
    x2 = x + 0.1

    def jax_side(v, v2):
        m = jnlp.convexify(jn, v, {})
        return (m, jnlp.eval_model_costs(jn, m, v2),
                jnlp.model_cost_total(jn, m, v2),
                jnlp.eval_exact_costs(jn, v2, {}))

    m_j, mc_j, tot_j, ex_j = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        jax_side))(jnp.asarray(x), jnp.asarray(x2)))
    xt, x2t = torch.as_tensor(x), torch.as_tensor(x2)
    m_t = tnlp.convexify(tn, xt, {})
    for name in m_j._fields:
        np.testing.assert_allclose(getattr(m_t, name).numpy(),
                                   getattr(m_j, name), rtol=0, atol=TOL,
                                   err_msg=name)
    # the projected Hessians are PSD and the diagonal one carries clamps
    assert np.linalg.eigvalsh(m_t.P.numpy()).min() > -1e-9
    np.testing.assert_allclose(tnlp.eval_model_costs(tn, m_t, x2t).numpy(),
                               mc_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tnlp.model_cost_total(tn, m_t, x2t).numpy(),
                               tot_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tnlp.eval_exact_costs(tn, x2t, {}).numpy(),
                               ex_j, rtol=0, atol=TOL)
