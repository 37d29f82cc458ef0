"""Port parity: the rest of the collision world against the JAX package,
float64 on the CPU.

* SDF worlds (``collision/sdf_grid.py`` and the SDF branch of
  ``collision/world.py``): a baked grid, queries inside and outside it with
  their gradients, and a scene's four query functions;
* randomized world geometry: ``center_param`` geoms read from ``params``
  per lane by the four query functions, ``check_trajectory`` and the
  collision terms;
* ``pair_distance`` / ``_swept_pair_distance`` for every primitive pairing;
* the robots ``rrbot``, ``boxbot``, ``spherebot``, ``arm6`` and
  ``arm6_scene``;
* whole solves of ``simple_collision_problem`` and of arm6 on its shelf:
  equal status and counts, x to 1e-6.

Values and Jacobians to 1e-9.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import geometry as jgeom
from trajopt_tpu.collision import sdf_grid as jsdf
from trajopt_tpu.collision import world as jworld
from trajopt_tpu.collision.check import check_trajectory as jcheck
from trajopt_tpu.kinematics.transforms import rpy_matrix as jrpy
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.problem.trajectory import TrajOptProblem as JProblem
from trajopt_tpu.terms.collision import collision_term as jcollision_term
from trajopt_tpu.terms.joint import joint_pos as jjoint_pos
from trajopt_tpu.terms.joint import joint_vel as jjoint_vel
from trajopt_tpu_torch import interop
from trajopt_tpu_torch.collision import geometry as tgeom
from trajopt_tpu_torch.collision import sdf_grid as tsdf
from trajopt_tpu_torch.collision import world as tworld
from trajopt_tpu_torch.collision.check import check_trajectory
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
from trajopt_tpu_torch.sqp.solver import make_solver
from trajopt_tpu_torch.terms.collision import collision_term
from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel

torch.set_num_threads(2)

TOL = 1e-9
REPO = Path(__file__).resolve().parents[1]
# the arm7 table scene's slab and post, the SDF world
BOXES = (((0.35, 0.5, 0.05), (0.55, 0.0, 0.25)),
         ((0.05, 0.05, 0.30), (0.39, 0.03, 1.00)))
LOWER, UPPER, SPACING = [-0.3, -0.9, -0.1], [1.3, 0.9, 1.5], 0.05


def _jax_world(p):
    return jnp.min(jnp.stack([jgeom.point_box_sdf(p - jnp.asarray(c),
                                                  jnp.asarray(h))
                              for h, c in BOXES]))


def _torch_world(pts):
    return torch.stack([tgeom.point_box_sdf(
        pts - torch.as_tensor(c, dtype=pts.dtype),
        torch.as_tensor(h, dtype=pts.dtype)) for h, c in BOXES]).amin(0)


@pytest.fixture(scope="module")
def grids():
    return (jsdf.bake_sdf(_jax_world, LOWER, UPPER, SPACING),
            tsdf.bake_sdf(_torch_world, LOWER, UPPER, SPACING))


def _points(n=200, seed=0):
    """Points inside the grid, outside it, and a few on its faces."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(np.array(LOWER) - 0.4, np.array(UPPER) + 0.4, (n, 3))
    p[:5] = np.array(LOWER) + [0.0, 0.3, 0.4]
    return p


def test_bake_matches_jax(grids):
    jg, tg = grids
    np.testing.assert_allclose(tg.values, np.asarray(jg.values), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(tg.origin, np.asarray(jg.origin))


def test_sdf_queries_and_gradients_match_jax(grids):
    jg, tg = grids
    p = _points()
    d_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(jg.query)))(
        jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    d = tg.query(pt)
    (g,) = torch.autograd.grad(d.sum(), [pt])
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(d_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=TOL)
    a, b = p[:100], p[100:]
    cap_j = jax.jit(jax.vmap(
        lambda x, y: jsdf.capsule_sdf_distance(jg, x, y, 0.05)))(
        jnp.asarray(a), jnp.asarray(b))
    cap = tsdf.capsule_sdf_distance(tg, torch.as_tensor(a),
                                    torch.as_tensor(b), 0.05)
    np.testing.assert_allclose(cap.numpy(), np.asarray(cap_j), rtol=0,
                               atol=TOL)


def _sdf_scene(pkg, grid):
    robots = jrobots if pkg == "jax" else trobots
    s = robots.arm7_scene(world_objects=False)
    s.add_link_box("link_4", [0.04, 0.04, 0.1], [0.0, 0.0, 0.2])
    s.add_world_sdf("world", grid)
    return s


def _sweep(n_dof, home, goal, seed):
    """(q [8, n], q0 [7, n], q1 [7, n]): a straight line and its gaps."""
    rng = np.random.default_rng(seed)
    w = np.linspace(0.0, 1.0, 8)[:, None]
    line = home * (1 - w) + goal * w + 0.05 * rng.standard_normal((8, n_dof))
    return line, line[:-1], line[1:]


def _four(ts, q, q0, q1, params=None):
    tree = ts.tree
    q, q0, q1 = (torch.as_tensor(v) for v in (q, q0, q1))
    return (ts.distances(tree.fk(q), params),
            *ts.distances_and_jac(tree.fk_with_axes(q), params),
            ts.swept_distances(tree.fk(q0), tree.fk(q1), params),
            *ts.swept_distances_and_jac(tree.fk_with_axes(q0),
                                        tree.fk_with_axes(q1), params))


def _jax_four(js, q, q0, q1):
    """The JAX references of :func:`_four`: the ``*_and_jac`` functions
    (one compile), whose distances stand for the value-only functions'."""
    d, J, sd, J0, J1 = jax.tree.map(np.asarray, jax.jit(lambda a, b, c: (
        *jax.vmap(js.distances_and_jac)(a),
        *jax.vmap(js.swept_distances_and_jac)(b, c)))(
            *(jnp.asarray(v) for v in (q, q0, q1))))
    return d, d, J, sd, sd, J0, J1


def _assert_four(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)


def test_sdf_scene_matches_jax(grids):
    jg, tg = grids
    js, ts = _sdf_scene("jax", jg), _sdf_scene("torch", tg)
    q, q0, q1 = _sweep(7, jbench.ARM7_HOME, jbench.ARM7_GOAL, 0)
    ref = _jax_four(js, q, q0, q1)
    assert ref[0].min() < 0.05       # near the post
    _assert_four(_four(ts, q, q0, q1), ref)


def _param_scene(pkg):
    robots = jrobots if pkg == "jax" else trobots
    s = robots.arm7_scene()
    s.add_world_sphere("ball", 0.08, [0.4, 0.3, 1.0], center_param="ball")
    s.add_world_box("crate", [0.1, 0.1, 0.1], [0.6, -0.3, 0.9],
                    center_param="crate")
    return s


def _centers(lanes, seed=1):
    rng = np.random.default_rng(seed)
    return {"ball": np.array([0.45, 0.15, 1.05])
            + 0.05 * rng.standard_normal((lanes, 3)),
            "crate": np.array([0.5, -0.2, 0.9])
            + 0.05 * rng.standard_normal((lanes, 3))}


def test_params_scene_matches_jax():
    """[lanes, steps] batches with one center per lane, against the JAX
    functions of one configuration and its params."""
    js, ts = _param_scene("jax"), _param_scene("torch")
    lanes = 3
    cs = _centers(lanes)
    qs = [_sweep(7, jbench.ARM7_HOME, jbench.ARM7_GOAL, s) for s in range(3)]
    q, q0, q1 = (np.stack([x[i] for x in qs]) for i in range(3))

    def lane(c_b, c_c, a, b, c):
        p = {"ball": c_b, "crate": c_c}
        return (*jax.vmap(lambda x: js.distances_and_jac(x, p))(a),
                *jax.vmap(lambda x, y: js.swept_distances_and_jac(
                    x, y, p))(b, c))

    d, J, sd, J0, J1 = jax.tree.map(np.asarray, jax.jit(jax.vmap(lane))(
        jnp.asarray(cs["ball"]), jnp.asarray(cs["crate"]),
        *(jnp.asarray(v) for v in (q, q0, q1))))
    ref = (d, d, J, sd, sd, J0, J1)
    params = {k: torch.as_tensor(v) for k, v in cs.items()}
    _assert_four(_four(ts, q, q0, q1, params), ref)
    # the centers move the distances
    assert np.abs(ref[0] - _four(ts, q, q0, q1)[0].numpy()).max() > 0.01


def test_check_trajectory_with_params_matches_jax():
    js, ts = _param_scene("jax"), _param_scene("torch")
    cs = _centers(2)
    traj = np.stack([_sweep(7, jbench.ARM7_HOME, jbench.ARM7_GOAL, s)[0][::2]
                     for s in range(2)])
    ok, dmin = check_trajectory(ts, torch.as_tensor(traj), margin=0.0,
                                substeps=3,
                                params={k: torch.as_tensor(v)
                                        for k, v in cs.items()})
    jok, jmin = jcheck(js, traj[0], margin=0.0, substeps=3,
                       params={k: jnp.asarray(v[0]) for k, v in cs.items()})
    assert bool(ok[0]) == bool(jok)
    np.testing.assert_allclose(float(dmin[0]), jmin, rtol=0, atol=TOL)
    # the second lane alone, with its own centers, as in the batch
    ok1, d1 = check_trajectory(ts, torch.as_tensor(traj[1]), substeps=3,
                               params={k: torch.as_tensor(v[1])
                                       for k, v in cs.items()})
    assert ok1 == bool(ok[1])
    np.testing.assert_allclose(d1, float(dmin[1]), rtol=0, atol=1e-14)


@pytest.mark.parametrize("evaluator", ["discrete", "cast"])
def test_collision_term_reads_params_like_jax(evaluator):
    n_steps, lanes = 5, 3
    js, ts = _param_scene("jax"), _param_scene("torch")
    kw = dict(margin=0.05, coeff=10.0, is_cost=False, evaluator=evaluator,
              fixed_steps=[0], lvs_substeps=2, max_num_cnt=4)
    jt = jcollision_term(js, n_steps, **kw)
    tt = collision_term(ts, n_steps, **kw)
    cs = _centers(lanes)
    x = np.stack([_sweep(7, jbench.ARM7_HOME, jbench.ARM7_GOAL, s)[0][:n_steps]
                  for s in range(lanes)]).reshape(lanes, -1)
    jp = {k: jnp.asarray(v) for k, v in cs.items()}
    tp = {k: torch.as_tensor(v) for k, v in cs.items()}
    rj, Wj = jax.jit(jax.vmap(jt.val_banded_jac))(jnp.asarray(x), jp)
    np.testing.assert_allclose(tt.fn(torch.as_tensor(x), tp).numpy(),
                               np.asarray(rj), rtol=0, atol=TOL)
    r, W = tt.val_banded_jac(torch.as_tensor(x), tp)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0, atol=TOL)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=0, atol=TOL)


KINDS = {
    "sphere": lambda m: m.CollGeom("s", "sphere", (0.2,)),
    "capsule": lambda m: m.CollGeom("c", "capsule", (0.1,),
                                    ea=np.array([-0.2, 0.0, 0.05]),
                                    eb=np.array([0.25, 0.1, -0.05])),
    "box": lambda m: m.CollGeom("b", "box", (0.2, 0.1, 0.3)),
}


@pytest.mark.parametrize("ka", sorted(KINDS))
@pytest.mark.parametrize("kb", sorted(KINDS))
def test_pair_distance_matches_jax(ka, kb):
    rng = np.random.default_rng(len(ka) * 7 + len(kb))
    n = 24
    rpy = rng.uniform(-np.pi, np.pi, (4, n, 3))
    R = np.asarray(jax.vmap(jax.vmap(jrpy))(jnp.asarray(rpy)))
    p = 0.4 * rng.standard_normal((3, n, 3))
    jga, jgb = KINDS[ka](jworld), KINDS[kb](jworld)
    tga, tgb = KINDS[ka](tworld), KINDS[kb](tworld)

    def jd(Ra, pa, Rb, pb):
        return jworld.pair_distance(jga, jgb, Ra, pa, Rb, pb, jnp.float64)

    def js(Ra0, pa0, Ra1, pa1, Rb, pb):
        return jworld._swept_pair_distance(jga, jgb, Ra0, pa0, Ra1, pa1, Rb,
                                           pb, jnp.float64)

    d_j = jax.jit(jax.vmap(jd))(*(jnp.asarray(v)
                                  for v in (R[0], p[0], R[1], p[1])))
    s_j = jax.jit(jax.vmap(js))(*(jnp.asarray(v) for v in (
        R[0], p[0], R[2], p[2], R[1], p[1])))
    Rt, pt = torch.tensor(R), torch.tensor(p)
    d = tworld.pair_distance(tga, tgb, Rt[0], pt[0], Rt[1], pt[1])
    s = tworld._swept_pair_distance(tga, tgb, Rt[0], pt[0], Rt[2], pt[2],
                                    Rt[1], pt[1])
    assert (np.asarray(d_j) < 0).any()
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["rrbot", "boxbot", "spherebot", "arm6"])
def test_robot_fk_matches_jax(name):
    jt, tt = getattr(jrobots, name)(), getattr(trobots, name)()
    assert tt.link_names == jt.link_names
    assert tt.active_joint_names == jt.active_joint_names
    np.testing.assert_array_equal(tt.lower, jt.lower)
    np.testing.assert_array_equal(tt.upper, jt.upper)
    q = np.random.default_rng(0).uniform(np.maximum(jt.lower, -3),
                                         np.minimum(jt.upper, 3),
                                         (5, jt.n_dof))
    R_j, p_j = jax.jit(jax.vmap(jt.fk))(jnp.asarray(q))
    R, p = tt.fk(torch.as_tensor(q))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=1e-12)


def test_arm6_scene_matches_jax():
    js, ts = jrobots.arm6_scene(), trobots.arm6_scene()
    assert [(a.name, b.name) for a, b in ts.pairs()] == \
        [(a.name, b.name) for a, b in js.pairs()]
    q, q0, q1 = _sweep(6, ARM6_HOME, ARM6_GOAL, 2)
    _assert_four(_four(ts, q, q0, q1), _jax_four(js, q, q0, q1))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _solver_params():
    """The JAX discrete workload's settings and the port's copy."""
    jp = _load("__graft_entry__")._solver_params("discrete")
    return jp, interop.sqp_params_from_dict(dataclasses.asdict(jp))


def _compare(res, ref):
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)


def test_simple_collision_solve_matches_jax():
    jparams, tparams = _solver_params()
    jprob, _ = jbench.simple_collision_problem()
    tprob, _ = tbench.simple_collision_problem(device="cpu")
    x0 = np.array([[-0.75, 0.75], [-0.7, 0.8], [0.6, -0.7]])
    solve = jprob.make_solve(jparams)
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i: solve(i, {})))(jnp.asarray(x0)[:, None, :]))
    res = make_solver(tprob.build(), tparams)(
        torch.as_tensor(x0), *tprob.bounds(torch.as_tensor(x0)), {})
    assert (ref.status == 1).all()
    _compare(res, ref)


ARM6_HOME = np.array([0.0, -1.2, 1.6, -0.4, 1.57, 0.0])
ARM6_GOAL = np.array([0.9, -1.0, 1.4, -0.4, 1.57, 0.3])


def _arm6_problem(pkg, n):
    if pkg == "jax":
        robots, Problem, jv, jpos, ct = (jrobots, JProblem, jjoint_vel,
                                         jjoint_pos, jcollision_term)
        kw = {}
    else:
        robots, Problem, jv, jpos, ct = (trobots, TrajOptProblem, joint_vel,
                                         joint_pos, collision_term)
        kw = {"device": "cpu"}
    tree = robots.arm6()
    prob = Problem(n_steps=n, n_dof=6, joint_lower=tree.lower,
                   joint_upper=tree.upper, fixed_steps=[0], **kw)
    prob.add_term(jv(n, 6, is_cost=True, coeffs=np.full(6, 5.0)))
    prob.add_term(jpos(n, 6, is_cost=False, targets="goal",
                       first_step=n - 1, last_step=n - 1))
    prob.add_term(ct(robots.arm6_scene(), n, margin=0.02, coeff=20.0,
                     is_cost=False, fixed_steps=[0]))
    return prob


def test_arm6_shelf_solve_matches_jax():
    """arm6 on its shelf (the JAX package's tests/test_arm6.py), 6 steps,
    3 lanes with goals around its goal."""
    n, lanes = 6, 3
    jparams, tparams = _solver_params()
    goals = ARM6_GOAL + 0.05 * np.random.default_rng(3).standard_normal(
        (lanes, 6))
    w = np.linspace(0.0, 1.0, n)[:, None]
    inits = ARM6_HOME * (1 - w) + goals[:, None, :] * w
    solve = _arm6_problem("jax", n).make_solve(jparams)
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i, g: solve(i, {"goal": g})))(jnp.asarray(inits),
                                              jnp.asarray(goals)))
    prob = _arm6_problem("torch", n)
    x0 = torch.as_tensor(inits).reshape(lanes, -1)
    res = make_solver(prob.build(), tparams)(
        x0, *prob.bounds(x0), {"goal": torch.as_tensor(goals)})
    assert (ref.status == 1).all()
    _compare(res, ref)
