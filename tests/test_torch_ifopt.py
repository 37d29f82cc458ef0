"""Port parity: the ifopt component model (``ifopt/__init__.py``) and its
typed constraint sets (``ifopt/constraints.py``) against the JAX package,
float64 on the CPU.

* the variable-set layout (starts, ``node_var`` handles, initial values,
  bounds, the rejections) is equal;
* lowering: for each problem of the JAX tests ``test_ifopt_facade.py`` and
  ``test_ifopt_typed_constraints.py`` the term sets' names, kinds and row
  counts are equal, and their values and Jacobians agree to 1e-9 at
  seeded points;
* ``bounds_errors`` and the cost wrappers' weights agree to 1e-12;
* every typed constraint's values agree to 1e-9 on one lane and on a
  batch, and the coefficient validation raises the same exception type;
* two solves through ``Problem.solve()``, one joint-space and one
  ``CartPosConstraint``: equal status and counts, x within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import ifopt as jifo
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu_torch import ifopt as tifo
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.sqp import nlp as tnlp

torch.set_num_threads(2)

PKGS = {"jax": (jifo, jrobots, jnp.asarray),
        "torch": (tifo, trobots,
                  lambda v: torch.tensor(v, dtype=torch.float64))}


def _traj(ifo, n_nodes, n_dof, init):
    """Problem with one trajectory variable set of per-node q Vars."""
    p = ifo.Problem()
    nodes = []
    for _ in range(n_nodes):
        nd = ifo.Node()
        nd.add_var("q", n_dof)
        nodes.append(nd)
    nv = p.add_variable_set(ifo.NodesVariables(
        "traj", nodes, init=np.asarray(init, float).reshape(-1)))
    return p, nv, [nv.node_var(t, "q") for t in range(n_nodes)]


def _fk_pose(tree, q, pkg):
    """(R, p) of the last link at q, as numpy."""
    R, p = tree.fk(PKGS[pkg][2](q))
    return np.asarray(R[-1]), np.asarray(p[-1])


# ------------------------------------------------------------ the problems
# Each builder makes the same problem in one package (the JAX tests'
# problems): ``build(pkg) -> Problem``.

def _target(pkg):
    ifo, _, K = PKGS[pkg]

    class Target(ifo.ConstraintSet):
        def __init__(self, vs, target):
            super().__init__(rows=len(target), name="target",
                             bounds=[ifo.Bounds.equality(t) for t in target])
            self._vs = vs

        def values(self, vars):  # noqa: A002
            return vars[self._vs.name]

    p = ifo.Problem()
    vs = p.add_variable_set(ifo.VariableSet("x", np.zeros(3)))
    p.add_constraint_set(Target(vs, [1.0, -2.0, 0.5]))
    p.add_cost_set(ifo.SquaredCost(
        ifo.FunctionalConstraint(3, "origin", lambda v: v["x"],
                                 ifo.Bounds.equality(0.0)), weights=1.0))
    return p


def _inequality(pkg):
    ifo, _, K = PKGS[pkg]
    p = ifo.Problem()
    p.add_variable_set(ifo.VariableSet("x", np.array([3.0, -3.0])))
    p.add_constraint_set(ifo.FunctionalConstraint(
        2, "box", lambda v: v["x"], ifo.Bounds(-1.0, 1.0)))
    p.add_constraint_set(ifo.FunctionalConstraint(
        2, "mixed", lambda v: v["x"] * v["x"],
        [ifo.Bounds(-np.inf, 4.0), ifo.Bounds(0.5, np.inf)]))
    p.add_cost_set(ifo.SquaredCost(
        ifo.FunctionalConstraint(
            2, "pull", lambda v: v["x"] - K([5.0, -5.0]),
            ifo.Bounds.equality(0.0))))
    return p


def _absolute(pkg):
    ifo, _, K = PKGS[pkg]
    p = ifo.Problem()
    p.add_variable_set(ifo.VariableSet("x", np.array([4.0])))
    p.add_cost_set(ifo.AbsoluteCost(
        ifo.FunctionalConstraint(1, "t", lambda v: v["x"] - 1.5,
                                 ifo.Bounds.equality(0.0)), weights=-2.0))
    return p


def _numerical_ik(pkg):
    ifo, robots, K = PKGS[pkg]
    tree = robots.arm7()
    target = np.asarray([0.35, 0.25, 0.55])
    home = np.asarray(jbench.ARM7_HOME)

    class IK(ifo.ConstraintSet):
        def __init__(self):
            super().__init__(rows=3, name="ik",
                             bounds=[ifo.Bounds.equality(t) for t in target])

        def values(self, vars):  # noqa: A002
            _, p = tree.fk(vars["q"])
            return p[-1]

    p = ifo.Problem()
    p.add_variable_set(ifo.VariableSet("q", home, lower=tree.lower,
                                       upper=tree.upper))
    p.add_constraint_set(IK())
    p.add_cost_set(ifo.SquaredCost(
        ifo.FunctionalConstraint(7, "posture", lambda v: v["q"] - K(home),
                                 ifo.Bounds.equality(0.0)), weights=0.01))
    return p


def _joint_pos(pkg):
    ifo = PKGS[pkg][0]
    p, _, pv = _traj(ifo, 3, 2, np.zeros(6))
    p.add_constraint_set(ifo.JointPosConstraint([0.3, -0.7], pv))
    return p


def _joint_diff(cls_name, init, ends):
    def build(pkg):
        ifo = PKGS[pkg][0]
        n = len(init)
        p, _, pv = _traj(ifo, n, 1, init)
        p.add_constraint_set(ifo.JointPosConstraint([ends[0]], [pv[0]],
                                                    name="start"))
        p.add_constraint_set(ifo.JointPosConstraint([ends[1]], [pv[-1]],
                                                    name="end"))
        p.add_cost_set(ifo.SquaredCost(getattr(ifo, cls_name)([0.0], pv),
                                       weights=1.0))
        return p
    return build


def _cart_pos(pkg):
    ifo, robots, _ = PKGS[pkg]
    tree = robots.rrbot()
    target = _fk_pose(jrobots.rrbot(), [0.6, -0.4], "jax")
    p = ifo.Problem()
    vs = p.add_variable_set(ifo.VariableSet("q", np.array([0.1, 0.1])))
    p.add_constraint_set(ifo.CartPosConstraint(
        tree, tree.link_names[-1], vs.var(), target))
    return p


def _cart_pos_indices(pkg):
    ifo, robots, _ = PKGS[pkg]
    tree = robots.rrbot()
    p = ifo.Problem()
    vs = p.add_variable_set(ifo.VariableSet("q", np.array([0.3, 0.2])))
    p.add_constraint_set(ifo.CartPosConstraint(
        tree, tree.link_names[-1], vs.var(), (np.eye(3), np.zeros(3)),
        indices=[0, 1, 2], coeffs=[2.0, 2.0, 2.0]))
    return p


def _cart_line(pkg):
    ifo, robots, _ = PKGS[pkg]
    tree = robots.rrbot()
    start = _fk_pose(jrobots.rrbot(), [0.4, -0.2], "jax")
    end = _fk_pose(jrobots.rrbot(), [0.9, -0.5], "jax")
    p = ifo.Problem()
    vs = p.add_variable_set(ifo.VariableSet("q", np.array([0.6, -0.3])))
    p.add_constraint_set(ifo.CartLineConstraint(
        tree, tree.link_names[-1], vs.var(), start, end, indices=[0, 1, 2]))
    return p


def _ik(pkg):
    ifo, robots, _ = PKGS[pkg]
    tree = robots.arm6()
    target = _fk_pose(jrobots.arm6(), [0.3, -0.5, 0.4, 0.2, -0.3, 0.1],
                      "jax")
    p = ifo.Problem()
    vs = p.add_variable_set(ifo.VariableSet("q", np.zeros(6)))
    p.add_constraint_set(ifo.InverseKinematicsConstraint(
        tree, tree.link_names[-1], vs.var(), target, q_seed=np.full(6, 0.1)))
    return p


PROBLEMS = {
    "target": _target, "inequality": _inequality, "absolute": _absolute,
    "numerical_ik": _numerical_ik, "joint_pos": _joint_pos,
    "joint_vel": _joint_diff("JointVelConstraint", [0.0, 0.1, 0.2, 0.9],
                             (0.0, 0.9)),
    "joint_accel": _joint_diff("JointAccelConstraint",
                               [0.0, 0.3, 0.1, 0.9, 2.0], (0.0, 2.0)),
    "joint_jerk": _joint_diff("JointJerkConstraint", np.linspace(0, 1, 6),
                              (0.0, 1.0)),
    "cart_pos": _cart_pos, "cart_pos_indices": _cart_pos_indices,
    "cart_line": _cart_line, "ik": _ik,
}


def _jax_terms(nlp, xs):
    """(rows, Jacobians) of every JAX term set at each point: one jitted
    program per problem."""
    def at(x):
        return [(t.fn(x, {}), jax.jacrev(lambda v, t=t: t.fn(v, {}))(x))
                for t in nlp.term_sets]
    return jax.jit(jax.vmap(at))(jnp.asarray(xs))


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_lowering_matches_jax(name):
    jp, tp = PROBLEMS[name]("jax"), PROBLEMS[name]("torch")
    jn, tn = jp.build(), tp.build()
    assert tn.n == jn.n
    assert [(t.name, t.kind.value, t.n_rows) for t in tn.term_sets] == \
        [(t.name, t.kind.value, t.n_rows) for t in jn.term_sets]
    np.testing.assert_array_equal(tp.initial_values(), jp.initial_values())
    for a, b in zip(tp.bounds(), jp.bounds()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    xs = jp.initial_values() + 0.3 * rng.standard_normal((4, jn.n))
    ref = _jax_terms(jn, xs)
    x = torch.as_tensor(xs)
    for tj, t, (r_j, J_j) in zip(jn.term_sets, tn.term_sets, ref):
        r, J = tnlp._residual_and_jac(t, x, {})
        np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=0,
                                   atol=1e-9, err_msg=t.name)
        np.testing.assert_allclose(J.numpy(), np.asarray(J_j), rtol=0,
                                   atol=1e-9, err_msg=t.name)
        np.testing.assert_array_equal(
            np.broadcast_to(t.weight_fn({}), (t.n_rows,)),
            np.broadcast_to(np.asarray(tj.weight_fn({})), (t.n_rows,)))


def test_variable_set_layout_matches_jax():
    out = {}
    for pkg in PKGS:
        ifo = PKGS[pkg][0]
        p = ifo.Problem()
        a = p.add_variable_set(ifo.VariableSet("a", np.array([1.0, 2.0]),
                                               lower=-5.0, upper=5.0))
        nodes = []
        for k in range(4):
            nd = ifo.Node(f"n{k}")
            nd.add_var("q", 2)
            nd.add_var("dt", 1)
            nodes.append(nd)
        nv = p.add_variable_set(ifo.NodesVariables(
            "traj", nodes, init=np.arange(12, dtype=float), upper=7.0))
        with pytest.raises(ValueError):
            p.add_variable_set(ifo.VariableSet("a", np.zeros(1)))
        with pytest.raises(KeyError):
            nv.node_var(0, "nope")
        with pytest.raises(ValueError):
            ifo.NodesVariables("bad", nodes, init=np.zeros(11))
        handles = [nv.node_var(k, v) for k in range(4) for v in ("q", "dt")]
        x = PKGS[pkg][2](np.arange(14.0))
        out[pkg] = (p.n, a.var(), [(h.start, h.size, h.name)
                                   for h in handles],
                    p.initial_values(), p.bounds(),
                    np.asarray(handles[5].value(x)),
                    np.asarray(ifo._VarReader(x, p._by_name)["traj"]))
    j, t = out["jax"], out["torch"]
    assert t[0] == j[0] == 14
    assert (t[1].start, t[1].size, t[1].name) == \
        (j[1].start, j[1].size, j[1].name)
    assert t[2] == j[2]
    np.testing.assert_array_equal(t[3], j[3])
    for a, b in zip(t[4], j[4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[5], j[5])
    np.testing.assert_array_equal(t[6], j[6])
    # Var.value also slices a batch
    xb = torch.arange(28.0).reshape(2, 14)
    np.testing.assert_array_equal(
        tifo.Var(10, 2).value(xb).numpy(), [[10, 11], [24, 25]])


def test_bounds_errors_and_cost_wrappers_match_jax():
    bounds = [jifo.Bounds(-1.0, 1.0), jifo.Bounds(-np.inf, 0.5),
              jifo.Bounds(0.2, np.inf), jifo.NoBound, jifo.Bounds.equality(3)]
    rng = np.random.default_rng(2)
    v = 3.0 * rng.standard_normal((5, 5))
    v[0] = [1.0, 0.5, 0.2, 0.0, 3.0]                 # on the bounds
    out = {}
    for pkg in PKGS:
        ifo, _, K = PKGS[pkg]
        bs = [ifo.Bounds(b.lower, b.upper) for b in bounds]
        cs = ifo.FunctionalConstraint(5, "c", lambda r: r["x"], bs)
        sq = ifo.SquaredCost(cs, weights=[1.0, -2.0, 3.0, 4.0, 5.0])
        ab = ifo.AbsoluteCost(cs, weights=-2.0)
        out[pkg] = (np.asarray(cs.bounds_errors(K(v))), sq.weights,
                    ab.weights, sq.name, ab.name, cs.lower, cs.upper)
    for a, b in zip(out["torch"], out["jax"]):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        tifo.ConstraintSet(3, "c", [tifo.NoBound] * 2)


def _typed_sets(pkg):
    """Every typed constraint, on one reader layout: (name, set) pairs."""
    ifo, robots, _ = PKGS[pkg]
    n_nodes, n_dof = 7, 2
    pv = [ifo.Var(n_dof * k, n_dof, f"q{k}") for k in range(n_nodes)]
    tgt = np.array([0.2, -0.1])
    rr = robots.rrbot()
    a6 = robots.arm6()
    a6_var = ifo.Var(0, 6, "q6")
    tcp = (np.eye(3), np.array([0.0, 0.0, 0.1]))
    pose = _fk_pose(jrobots.rrbot(), [0.6, -0.4], "jax")
    target6 = _fk_pose(jrobots.arm6(), [0.3, -0.5, 0.4, 0.2, -0.3, 0.1],
                       "jax")
    return [
        ("pos", ifo.JointPosConstraint(tgt, pv[:3], coeffs=[2.0, 3.0])),
        ("vel", ifo.JointVelConstraint(tgt, pv, coeffs=2.0)),
        ("accel", ifo.JointAccelConstraint(tgt, pv)),
        ("jerk", ifo.JointJerkConstraint(tgt, pv, coeffs=[1.0, 0.5])),
        ("cart_pos", ifo.CartPosConstraint(
            rr, rr.link_names[-1], pv[1], pose, tcp=tcp, target_tcp=tcp,
            coeffs=[1.0, 2.0, 3.0, 4.0, 5.0, 6.0])),
        ("cart_pos_idx", ifo.CartPosConstraint(
            rr, rr.link_names[-1], pv[2], pose, indices=[0, 2, 5],
            coeffs=0.5)),
        ("cart_line", ifo.CartLineConstraint(
            rr, rr.link_names[-1], pv[3],
            _fk_pose(jrobots.rrbot(), [0.4, -0.2], "jax"),
            _fk_pose(jrobots.rrbot(), [0.9, -0.5], "jax"), tcp=tcp)),
        ("ik", ifo.InverseKinematicsConstraint(
            a6, a6.link_names[-1], a6_var, target6, q_seed=np.full(6, 0.1),
            coeffs=[1.0, 2.0, 1.0, 2.0, 1.0, 2.0])),
    ]


def test_typed_constraints_match_jax():
    rng = np.random.default_rng(5)
    xs = rng.uniform(-1.0, 1.0, (3, 14))
    jsets, tsets = _typed_sets("jax"), _typed_sets("torch")
    for (name, j), (_, t) in zip(jsets, tsets):
        assert (t.rows, t.name) == (j.rows, j.name), name
        np.testing.assert_array_equal(t.lower, j.lower)
        np.testing.assert_array_equal(t.upper, j.upper)
        ref = np.stack([np.asarray(j.values(jifo._VarReader(jnp.asarray(x),
                                                            {})))
                        for x in xs])
        batch = t.values(tifo._VarReader(torch.as_tensor(xs), {})).numpy()
        lane = t.values(tifo._VarReader(torch.as_tensor(xs[0]), {})).numpy()
        np.testing.assert_allclose(batch, ref, rtol=0, atol=1e-9,
                                   err_msg=name)
        np.testing.assert_allclose(lane, ref[0], rtol=0, atol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(tsets[-1][1].q_ik, jsets[-1][1].q_ik,
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["negative", "size", "too_few", "var_size",
                                  "accel_few", "jerk_few"])
def test_coefficient_validation_raises_alike(case):
    def make(pkg):
        ifo = PKGS[pkg][0]
        pv = [ifo.Var(2 * k, 2, f"q{k}") for k in range(3)]
        tgt = np.zeros(2)
        if case == "negative":
            return ifo.JointVelConstraint(tgt, pv, coeffs=-1.0)
        if case == "size":
            return ifo.JointVelConstraint(tgt, pv, coeffs=[1.0, 2.0, 3.0])
        if case == "too_few":
            return ifo.JointVelConstraint(tgt, pv[:1])
        if case == "var_size":
            return ifo.JointPosConstraint(np.zeros(3), pv)
        if case == "accel_few":
            return ifo.JointAccelConstraint(tgt, pv)
        return ifo.JointJerkConstraint(tgt, pv + pv[:2])

    errors = []
    for pkg in PKGS:
        with pytest.raises(Exception) as info:
            make(pkg)
        errors.append(type(info.value))
    assert errors[0] is errors[1] is ValueError
    # the reference's default velocity coefficient is 5
    c = tifo.JointVelConstraint(np.zeros(2), [tifo.Var(0, 2),
                                              tifo.Var(2, 2)])
    np.testing.assert_allclose(c.coeffs, 5.0)


@pytest.mark.parametrize("name", ["joint_vel", "cart_pos"])
def test_solve_matches_jax(name):
    jres, jvals = PROBLEMS[name]("jax").solve()
    tres, tvals = PROBLEMS[name]("torch").solve(device="cpu")
    fields = ("status", "n_iter", "n_qp_solves", "n_func_evals")
    assert [int(getattr(tres, f)) for f in fields] == \
        [int(getattr(jres, f)) for f in fields]
    assert int(tres.status) == 1
    assert tres.x.shape == (PROBLEMS[name]("torch").n,)
    assert tvals.keys() == jvals.keys()
    for k in jvals:
        np.testing.assert_allclose(tvals[k], np.asarray(jvals[k]), rtol=0,
                                   atol=1e-6)
