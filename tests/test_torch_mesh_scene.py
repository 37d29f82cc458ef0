"""Port parity: mesh and SRDF scenes against the JAX package, float64 on the
CPU.

* ``collision/decompose.py``: STL (binary, from the port's writer, and
  ASCII) and OBJ loading, ``box_mesh`` / ``concat_meshes``, the primitive
  fits and ``decompose`` equal, ``add_decomposition`` registering the same
  geometry;
* ``kinematics/srdf.py``: ``parse_srdf`` / ``load_srdf``,
  ``resolve_group_joints``, ``group_state_vector`` and the allowed-collision
  pairs equal;
* ``scene_from_urdf`` from a URDF whose links are binary STL meshes written
  to ``tmp_path`` (the mesh arm, ``models/robots.py``), in ``"hull"`` and
  ``"decompose"`` modes with the SRDF's ACM: equal geometry and pairs, the
  four query functions to 1e-9; ``resolve_resource``;
* a whole solve of the mesh arm across its post (8 steps, 3 lanes): equal
  status and counts, x to 1e-6.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import decompose as jdc
from trajopt_tpu.collision import world as jworld
from trajopt_tpu.kinematics import srdf as jsrdf
from trajopt_tpu.kinematics.chain import build_tree as jbuild_tree
from trajopt_tpu.kinematics.urdf import parse_urdf as jparse_urdf
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.problem.trajectory import TrajOptProblem as JProblem
from trajopt_tpu.terms.collision import collision_term as jcollision_term
from trajopt_tpu.terms.joint import joint_pos as jjoint_pos
from trajopt_tpu.terms.joint import joint_vel as jjoint_vel
from trajopt_tpu_torch import interop
from trajopt_tpu_torch.collision import decompose as tdc
from trajopt_tpu_torch.collision import world as tworld
from trajopt_tpu_torch.kinematics import srdf as tsrdf
from trajopt_tpu_torch.kinematics.chain import build_tree
from trajopt_tpu_torch.kinematics.urdf import parse_urdf
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.sqp.solver import make_solver

torch.set_num_threads(2)

TOL = 1e-9
REPO = Path(__file__).resolve().parents[1]


def _concave():
    """An L-shaped (concave) mesh: two boxes."""
    return tdc.concat_meshes(tdc.box_mesh([0.3, 0.05, 0.05]),
                             tdc.box_mesh([0.05, 0.2, 0.05],
                                          center=[0.25, 0.25, 0.0]))


def test_meshes_load_alike(tmp_path):
    m = _concave()
    jm = jdc.concat_meshes(jdc.box_mesh([0.3, 0.05, 0.05]),
                           jdc.box_mesh([0.05, 0.2, 0.05],
                                        center=[0.25, 0.25, 0.0]))
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.faces, jm.faces)
    stl = str(tmp_path / "l.stl")
    tdc.save_stl(stl, m)
    for a, b in ((tdc.load_stl(stl), jdc.load_stl(stl)),
                 (tdc.load_mesh(stl), jdc.load_mesh(stl))):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
    assert tdc.load_stl(stl).faces.shape == (24, 3)
    lines = ["solid l"]
    for tri in m.faces:
        lines += [" facet normal 0 0 0", "  outer loop"]
        lines += [f"   vertex {v[0]} {v[1]} {v[2]}" for v in m.vertices[tri]]
        lines += ["  endloop", " endfacet"]
    (tmp_path / "a.stl").write_text("\n".join(lines + ["endsolid l"]))
    obj = ["v {} {} {}".format(*v) for v in m.vertices]
    obj += ["f {} {} {}".format(*(f + 1)) for f in m.faces]
    (tmp_path / "m.obj").write_text("\n".join(obj))
    for name in ("a.stl", "m.obj"):
        a, b = (mod.load_mesh(str(tmp_path / name)) for mod in (tdc, jdc))
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)


def _pieces_equal(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert p.kind == q.kind
        for x, y in zip(p.params, q.params):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
        for f in ("center", "R", "hull_vertices"):
            np.testing.assert_allclose(getattr(p, f), getattr(q, f), rtol=0,
                                       atol=1e-12)
        np.testing.assert_allclose(p.volume, q.volume, rtol=1e-12)


def test_decompose_matches_jax():
    m = _concave()
    jm = jdc.Mesh(m.vertices, m.faces)
    pieces = tdc.decompose(m, max_concavity=0.01, max_pieces=8)
    assert len(pieces) >= 2
    _pieces_equal(pieces, jdc.decompose(jm, max_concavity=0.01,
                                        max_pieces=8))
    pts = np.random.default_rng(0).normal(size=(40, 3)) * [0.3, 0.1, 0.05]
    _pieces_equal([tdc.fit_primitive(pts)], [jdc.fit_primitive(pts)])


def _geoms_equal(ts, js):
    assert len(ts.geoms) == len(js.geoms)
    for t, j in zip(ts.geoms, js.geoms):
        assert (t.name, t.kind, t.link) == (j.name, j.kind, j.link)
        np.testing.assert_allclose(t.params, j.params, rtol=0, atol=1e-12)
        for f in ("R_local", "p_local", "ea", "eb", "verts", "normals",
                  "edges"):
            a, b = getattr(t, f), getattr(j, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert [(a.name, b.name) for a, b in ts.pairs()] == \
        [(a.name, b.name) for a, b in js.pairs()]


def test_add_decomposition_matches_jax():
    m = _concave()
    ts = tworld.CollisionScene(trobots.arm7())
    js = jworld.CollisionScene(jrobots.arm7())
    for scene, dc in ((ts, tdc), (js, jdc)):
        dc.add_decomposition(scene, dc.Mesh(m.vertices, m.faces),
                             link="link_4", name="grip", max_concavity=0.01,
                             max_pieces=6)
        dc.add_decomposition(scene, dc.Mesh(m.vertices + [0.5, 0, 0.8],
                                            m.faces), name="shelf",
                             max_concavity=0.01, max_pieces=6)
    _geoms_equal(ts, js)


SRDF = """<robot name="mesh_arm">
  <group name="shoulder"><joint name="shoulder"/></group>
  <group name="forearm"><link name="fore"/></group>
  <group name="both"><group name="forearm"/><group name="shoulder"/></group>
  <group name="arm"><chain base_link="base" tip_link="fore"/></group>
  <group_state name="home" group="arm">
    <joint name="shoulder" value="-1.2"/><joint name="elbow" value="0.3"/>
  </group_state>
  <group_state name="bent" group="both">
    <joint name="elbow" value="1.5"/>
  </group_state>
  <disable_collisions link1="base" link2="fore" reason="Never"/>
  <disable_collisions link1="upper" link2="base" reason="Adjacent"/>
</robot>
"""


def test_srdf_matches_jax(tmp_path):
    path = tmp_path / "mesh_arm.srdf"
    path.write_text(SRDF)
    t, j = tsrdf.load_srdf(str(path)), jsrdf.load_srdf(str(path))
    assert t.name == j.name
    assert [dataclasses.astuple(g) for g in t.groups] == \
        [dataclasses.astuple(g) for g in j.groups]
    assert t.group_states == j.group_states
    assert t.disabled_collisions == j.disabled_collisions
    assert t.disabled_link_pairs() == j.disabled_link_pairs()
    tm, jm = (parse_urdf(trobots.MESH_ARM_URDF),
              jparse_urdf(trobots.MESH_ARM_URDF))
    for g in ("shoulder", "forearm", "both", "arm"):
        assert tsrdf.resolve_group_joints(tm, t, g) == \
            jsrdf.resolve_group_joints(jm, j, g)
    for st in ("home", "bent"):
        np.testing.assert_array_equal(tsrdf.group_state_vector(tm, t, st),
                                      jsrdf.group_state_vector(jm, j, st))
    with pytest.raises(KeyError):
        t.group("missing")
    with pytest.raises(ValueError):
        tsrdf.parse_srdf("<robot><disable_collisions link1='a'/></robot>")


def test_resolve_resource_matches_jax():
    for f, m in (("/abs/x.stl", None), ("file:///abs/x.stl", None),
                 ("package://pkg/d/x.stl", {"pkg": "/srv/pkg"})):
        assert tworld.resolve_resource(f, m) == jworld.resolve_resource(f, m)
    with pytest.raises(ValueError, match="package_map"):
        tworld.resolve_resource("package://pkg/x.stl", None)


def _jax_mesh_arm(directory, mesh_mode="hull"):
    model = jparse_urdf(trobots.MESH_ARM_URDF)
    scene = jworld.scene_from_urdf(
        jbuild_tree(model), model, jsrdf.parse_srdf(trobots.MESH_ARM_SRDF),
        package_map={"mesh_arm": directory}, mesh_mode=mesh_mode)
    half, center = trobots.MESH_ARM_POST
    scene.add_world_box("post", half, center)
    return scene


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    return trobots.write_mesh_arm(str(tmp_path_factory.mktemp("mesh_arm")))


def test_scene_from_urdf_matches_jax(mesh_dir):
    ts, js = trobots.mesh_arm_scene(mesh_dir), _jax_mesh_arm(mesh_dir)
    assert [g.kind for g in ts.geoms] == ["box", "convex", "convex", "box"]
    assert frozenset(("base", "fore")) in ts.disabled_link_pairs
    _geoms_equal(ts, js)
    model = parse_urdf(trobots.MESH_ARM_URDF)
    td = tworld.scene_from_urdf(build_tree(model), model,
                                package_map={"mesh_arm": mesh_dir},
                                mesh_mode="decompose")
    jmodel = jparse_urdf(trobots.MESH_ARM_URDF)
    jd = jworld.scene_from_urdf(jbuild_tree(jmodel), jmodel,
                                package_map={"mesh_arm": mesh_dir},
                                mesh_mode="decompose")
    _geoms_equal(td, jd)
    with pytest.raises(ValueError, match="mesh_mode"):
        tworld.scene_from_urdf(build_tree(model), model, mesh_mode="vhacd")


def test_mesh_scene_queries_match_jax(mesh_dir):
    ts, js = trobots.mesh_arm_scene(mesh_dir), _jax_mesh_arm(mesh_dir)
    w = np.linspace(0.0, 1.0, 9)[:, None]
    line = tbench.MESH_ARM_HOME * (1 - w) + tbench.MESH_ARM_GOAL * w
    q, q0, q1 = line, line[:-1], line[1:]
    jq, jq0, jq1 = (jnp.asarray(v) for v in (q, q0, q1))
    ref = jax.tree.map(np.asarray, (
        jax.jit(jax.vmap(js.distances))(jq),
        *jax.jit(jax.vmap(js.distances_and_jac))(jq),
        jax.jit(jax.vmap(js.swept_distances))(jq0, jq1),
        *jax.jit(jax.vmap(js.swept_distances_and_jac))(jq0, jq1)))
    tree = ts.tree
    q, q0, q1 = (torch.as_tensor(v) for v in (q, q0, q1))
    got = (ts.distances(tree.fk(q)), *ts.distances_and_jac(
        tree.fk_with_axes(q)), ts.swept_distances(tree.fk(q0), tree.fk(q1)),
        *ts.swept_distances_and_jac(tree.fk_with_axes(q0),
                                    tree.fk_with_axes(q1)))
    assert ref[3].min() < 0          # the straight line sweeps the post
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL)
    # the scene carried across as numpy builds the same scene
    carried = interop.scene_from_numpy(interop.scene_to_numpy(js))
    np.testing.assert_allclose(carried.distances(tree.fk(q)).numpy(), ref[0],
                               rtol=0, atol=TOL)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_arm_solve_matches_jax(mesh_dir):
    n, lanes = 8, 3
    jparams = _load("__graft_entry__")._solver_params("discrete")
    tparams = interop.sqp_params_from_dict(dataclasses.asdict(jparams))
    js = _jax_mesh_arm(mesh_dir)
    jtree = js.tree
    jprob = JProblem(n_steps=n, n_dof=2, joint_lower=jtree.lower,
                     joint_upper=jtree.upper, fixed_steps=[0])
    jprob.add_term(jjoint_vel(n, 2, is_cost=True, coeffs=np.full(2, 5.0)))
    jprob.add_term(jjoint_pos(n, 2, is_cost=False, targets="goal",
                              first_step=n - 1, last_step=n - 1))
    jprob.add_term(jcollision_term(js, n, margin=0.02, coeff=20.0,
                                   is_cost=False, evaluator="lvs_discrete",
                                   lvs_substeps=3, fixed_steps=[0]))
    goals = tbench.MESH_ARM_GOAL + 0.05 * np.random.default_rng(3) \
        .standard_normal((lanes, 2))
    w = np.linspace(0.0, 1.0, n)[:, None]
    inits = tbench.MESH_ARM_HOME * (1 - w) + goals[:, None, :] * w
    solve = jprob.make_solve(jparams)
    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda i, g: solve(i, {"goal": g})))(jnp.asarray(inits),
                                              jnp.asarray(goals)))
    prob, _ = tbench.mesh_arm_problem(mesh_dir, n, device="cpu")
    x0 = torch.as_tensor(inits).reshape(lanes, -1)
    res = make_solver(prob.build(), tparams)(
        x0, *prob.bounds(x0), {"goal": torch.as_tensor(goals)})
    assert (ref.status == 1).all() and (ref.n_iter > 2).all()
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)
