"""Port parity: the arm7 model and the discrete collision path of
``trajopt_tpu_torch`` against the JAX package, float64 on the CPU.

* FK of arm7 and the arm7 scene's candidate pairs;
* the discrete narrowphase (``CollisionScene.distances`` and
  ``distances_and_jac``) on seeded arm7 and pr2ish configurations,
  penetrating ones included;
* the ``discrete`` collision term's rows and dense and banded Jacobians,
  with and without the per-step top-k, as constraint and as cost;
* the dense ``convexify`` (every ``ConvexModel`` field) and the model
  evaluations the trust region reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.sqp import nlp as jnlp
from trajopt_tpu.terms import collision as jcol
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.sqp import nlp as tnlp
from trajopt_tpu_torch.terms import collision as tcol

torch.set_num_threads(2)

TOL = 1e-9
N_STEPS = 6


def _configs(tree, home, goal, seed):
    """[12, n_dof]: the straight home -> goal line (for arm7 it runs
    through the post: penetrating) and random configurations."""
    rng = np.random.default_rng(seed)
    w = np.linspace(0.0, 1.0, 6)[:, None]
    line = home * (1 - w) + goal * w
    rand = rng.uniform(tree.lower, tree.upper, (6, tree.n_dof))
    return np.concatenate([line, rand])


SCENES = {
    "arm7": (jrobots.arm7_scene, trobots.arm7_scene, jbench.ARM7_HOME,
             jbench.ARM7_GOAL),
    "pr2ish": (jrobots.pr2ish_scene, trobots.pr2ish_scene,
               jbench.PR2ISH_HOME, jbench.PR2ISH_GOAL),
}


def test_arm7_fk_matches_jax():
    jtree, ttree = jrobots.arm7(), trobots.arm7()
    q = _configs(ttree, jbench.ARM7_HOME, jbench.ARM7_GOAL, 0)
    R_j, p_j = jax.vmap(jtree.fk)(jnp.asarray(q))
    R_t, p_t = ttree.fk(torch.as_tensor(q))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-12)
    assert ttree.link_names == jtree.link_names
    np.testing.assert_array_equal(ttree.lower, jtree.lower)
    np.testing.assert_array_equal(ttree.upper, jtree.upper)


def test_arm7_pairs_match_jax():
    names = [(a.name, b.name) for a, b in trobots.arm7_scene().pairs()]
    assert names == [(a.name, b.name)
                     for a, b in jrobots.arm7_scene().pairs()]
    assert len(names) == 8


@pytest.mark.parametrize("robot", list(SCENES))
def test_discrete_distances_and_jac_match_jax(robot):
    jmake, tmake, home, goal = SCENES[robot]
    jscene, tscene = jmake(), tmake()
    tree = tscene.tree
    q = _configs(tree, home, goal, 1)
    qj = jnp.asarray(q)
    d_j, (dj_j, J_j) = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda v: (jscene.distances(v), jscene.distances_and_jac(v))))(qj))
    assert d_j.min() < 0 < d_j.max()            # penetration and clearance
    qt = torch.as_tensor(q.reshape(3, 4, -1))   # any leading batch shape
    d_t = tscene.distances(tree.fk(qt)).reshape(d_j.shape)
    dj_t, J_t = tscene.distances_and_jac(tree.fk_with_axes(qt))
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(dj_t.reshape(d_j.shape).numpy(), dj_j,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(J_t.reshape(J_j.shape).numpy(), J_j, rtol=0,
                               atol=TOL)


TERMS = {
    "arm7_constraint": ("arm7", dict(is_cost=False)),
    "arm7_cost_pair_override": ("arm7", dict(
        is_cost=True, pair_coeffs={("link_4", "post"): 7.0},
        fixed_steps=[0, 3])),
    "pr2ish_topk": ("pr2ish", dict(is_cost=False, max_num_cnt=5)),
}


@pytest.mark.parametrize("case", list(TERMS))
def test_discrete_term_matches_jax(case):
    robot, kw = TERMS[case]
    jmake, tmake, home, goal = SCENES[robot]
    jscene, tscene = jmake(), tmake()
    kw = dict(margin=0.05, coeff=20.0, evaluator="discrete", **kw)
    jt = jcol.collision_term(jscene, N_STEPS, **kw)
    tt = tcol.collision_term(tscene, N_STEPS, **kw)
    assert (tt.kind.value, tt.n_rows, tt.band_width, tt.n_groups) == \
        (jt.kind.value, jt.n_rows, jt.band_width, jt.n_groups)
    np.testing.assert_array_equal(tt.band_starts, jt.band_starts)
    if jt.groups is not None:
        np.testing.assert_array_equal(tt.groups, jt.groups)
    rng = np.random.default_rng(2)
    w = np.linspace(0.0, 1.0, N_STEPS)[:, None]
    line = (home * (1 - w) + goal * w).reshape(-1)
    x = line + 0.05 * rng.standard_normal((3, line.size))
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    raw_j, (vals_j, J_j), (_, W_j) = jax.tree.map(np.asarray, jax.jit(
        jax.vmap(lambda v: (jt.fn(v, {}), jt.val_jac_fn(v, {}),
                            jt.val_banded_jac(v, {}))))(xj))
    assert raw_j.max() > 0                      # some rows violated
    np.testing.assert_allclose(vals_j, raw_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(tt.fn(xt, {}).numpy(), raw_j, rtol=0,
                               atol=TOL)
    # the JAX val_* Jacobians equal its jac_fn / banded_jac
    for name, ref in (("jac_fn", J_j), ("banded_jac", W_j)):
        np.testing.assert_allclose(getattr(tt, name)(xt, {}).numpy(), ref,
                                   rtol=0, atol=TOL, err_msg=name)
    for name, ref in (("val_jac_fn", J_j), ("val_banded_jac", W_j)):
        vals, J = getattr(tt, name)(xt, {})
        np.testing.assert_allclose(vals.numpy(), raw_j, rtol=0, atol=TOL)
        np.testing.assert_allclose(J.numpy(), ref, rtol=0, atol=TOL,
                                   err_msg=name)


def _arm7_model_inputs():
    goals = tbench.arm7_goals(3, 2)
    w = np.linspace(0.0, 1.0, N_STEPS)[:, None]
    x = (tbench.ARM7_HOME * (1 - w) + goals[:, None, :] * w).reshape(2, -1)
    x = x + 0.03 * np.random.default_rng(4).standard_normal(x.shape)
    return x, goals


def test_convexify_matches_jax():
    jprob, _ = jbench.arm_table_problem(n_steps=N_STEPS)
    jn = jprob.build()
    tprob, _ = tbench.arm_table_problem(n_steps=N_STEPS, device="cpu")
    tn = tprob.build()
    x, goals = _arm7_model_inputs()

    def jax_model(x1, g):
        p = {"goal": g}
        return jnlp.convexify(jn, x1, p,
                              jnlp.linear_jacobians(jn, jn.n, p, x1.dtype))

    m_j = jax.jit(jax.vmap(jax_model))(jnp.asarray(x), jnp.asarray(goals))
    xt, p = torch.as_tensor(x), {"goal": torch.as_tensor(goals)}
    m_t = tnlp.convexify(tn, xt, p, tnlp.linear_jacobians(tn, xt, p))
    for name in m_t._fields:
        np.testing.assert_allclose(getattr(m_t, name).numpy(),
                                   np.asarray(getattr(m_j, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)

    x2 = x + 0.02 * np.random.default_rng(5).standard_normal(x.shape)
    x2j, x2t = jnp.asarray(x2), torch.as_tensor(x2)
    for fn in ("eval_model_costs", "model_cost_total",
               "eval_model_cnt_viols"):
        ref = jax.vmap(lambda m, v: getattr(jnlp, fn)(jn, m, v))(m_j, x2j)
        got = getattr(tnlp, fn)(tn, m_t, x2t)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-10, err_msg=fn)
