"""Port parity: the JSON problem front end (``problem/json_io.py``), the
independent checker (``collision/check.py``), the plots and MPC against
the JAX package, float64 on the CPU.

* the parsed problems agree on ``arm_table.json`` and the documents of
  ``tests/test_json_io.py`` (the simple-collision, cast, Cartesian, dynamic
  Cartesian, time, user-defined, link-pair override and per-step vector
  documents): term names, kinds, row counts and band layouts, bounds,
  inits and ``SQPParams``.  The spherebot and boxbot trees come from the
  same URDF text as ``tests/test_collision.py``, parsed by each package;
* each rejection raises the same exception type;
* a 10-step ``arm_table.json`` solve: equal status and counts, x to 1e-6;
* ``check_trajectory``: equal ``ok`` and ``dmin`` to 1e-9, one trajectory
  and a batch;
* ``convex_solver: BPMPD`` takes the IPM, at parity; ``native`` the host
  reference driver (at parity in ``test_torch_reference_json.py``);
* ``log_results`` writes the CSV logs; both plotting functions and the
  plotter callbacks write PNGs under the Agg backend;
* two ``make_mpc_step`` cycles with goal drift and ``reinit_goal_key``:
  x to 1e-6.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import world as jworld
from trajopt_tpu.collision.check import check_trajectory as jax_check
from trajopt_tpu.kinematics import chain as jchain
from trajopt_tpu.kinematics import urdf as jurdf
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.problem import json_io as jjson
from trajopt_tpu.problem.mpc import make_mpc_step as jax_mpc_step
from trajopt_tpu.terms import user as juser
from trajopt_tpu_torch.collision import world as tworld
from trajopt_tpu_torch.collision.check import check_trajectory
from trajopt_tpu_torch.interop import sqp_params_from_dict
from trajopt_tpu_torch.kinematics import chain as tchain
from trajopt_tpu_torch.kinematics import urdf as turdf
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models import robots as trobots
from trajopt_tpu_torch.problem import json_io as tjson
from trajopt_tpu_torch.problem.mpc import make_mpc_step
from trajopt_tpu_torch.terms import user as tuser

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM_TABLE = os.path.join(REPO, "trajopt_tpu_torch", "data", "config",
                         "arm_table.json")

SPHEREBOT_URDF = """
<robot name="spherebot">
  <link name="world"/><link name="xc"/><link name="ball"/>
  <joint name="x" type="prismatic"><parent link="world"/><child link="xc"/>
    <axis xyz="1 0 0"/><limit lower="-10" upper="10"/></joint>
  <joint name="y" type="prismatic"><parent link="xc"/><child link="ball"/>
    <axis xyz="0 1 0"/><limit lower="-10" upper="10"/></joint>
</robot>"""

BOXBOT_URDF = """
<robot name="boxbot">
  <link name="world"/><link name="xc"/><link name="box"/>
  <joint name="x" type="prismatic"><parent link="world"/><child link="xc"/>
    <axis xyz="1 0 0"/><limit lower="-10" upper="10"/></joint>
  <joint name="y" type="prismatic"><parent link="xc"/><child link="box"/>
    <axis xyz="0 1 0"/><limit lower="-10" upper="10"/></joint>
</robot>"""


def _bot_scene(world, chain, urdf_mod, text, link_geom):
    scene = world.CollisionScene(chain.build_tree(urdf_mod.parse_urdf(text)))
    if link_geom == "sphere":
        scene.add_link_sphere("ball", 0.25)
    else:
        scene.add_link_box("box", [0.5, 0.5, 0.5])
    scene.add_world_box("obstacle", [0.5, 0.5, 0.5], [0.0, 0.0, 0.0])
    return scene


def _rrbot(pkg):
    path = os.path.join(REPO, "trajopt_tpu", "data", "rrbot.urdf")
    if pkg == "jax":
        return jrobots.rrbot()
    return tchain.build_tree(turdf.load_urdf(path))


def _env(pkg, robot, state=None):
    """(module, Environment) of one package for a robot name."""
    mod = jjson if pkg == "jax" else tjson
    if robot in ("spherebot", "boxbot"):
        world, chain, urdf_mod = ((jworld, jchain, jurdf) if pkg == "jax"
                                  else (tworld, tchain, turdf))
        text = SPHEREBOT_URDF if robot == "spherebot" else BOXBOT_URDF
        scene = _bot_scene(world, chain, urdf_mod, text,
                           "sphere" if robot == "spherebot" else "box")
        return mod, mod.Environment(tree=scene.tree, scene=scene,
                                    current_state=state)
    if robot == "rrbot":
        return mod, mod.Environment(tree=_rrbot(pkg), current_state=state)
    robots = jrobots if pkg == "jax" else trobots
    return mod, mod.Environment(tree=robots.arm7(), scene=robots.arm7_scene(),
                                current_state=state)


SIMPLE_COLLISION_DOC = {
    "basic_info": {"n_steps": 1, "manip": "manipulator"},
    "costs": [
        {"type": "collision",
         "params": {"coeffs": 1, "dist_pen": 0.3, "evaluator_type": 1,
                    "longest_valid_segment_length": 0.05}},
        {"type": "joint_pos", "name": "joint0",
         "params": {"coeffs": [1, 1], "targets": [0.0, 0.0],
                    "first_step": 0, "last_step": 0}},
    ],
    "constraints": [
        {"type": "collision",
         "params": {"coeffs": 1, "dist_pen": 0.2, "evaluator_type": 1,
                    "longest_valid_segment_length": 0.05}},
    ],
    "init_info": {"type": "given_traj", "data": [[-0.75, 0.75]]},
}

CAST_DOC = {
    "basic_info": {"n_steps": 3, "manip": "manipulator",
                   "fixed_timesteps": [0, 2]},
    "costs": [
        {"type": "joint_vel", "name": "jvel0",
         "params": {"coeffs": [1, 1], "targets": [0, 0]}},
    ],
    "constraints": [
        {"type": "collision",
         "params": {"coeffs": 20, "dist_pen": 0.05, "evaluator_type": 3,
                    "fixed_steps": [0, 2]}},
    ],
    "init_info": {"type": "given_traj",
                  "data": [[-1.9, 0.0], [0.0, 1.2], [1.9, 0.0]]},
}

CART_DOC = {
    "basic_info": {"n_steps": 2, "manip": "m"},
    "constraints": [
        {"type": "cart_pose",
         "params": {"timestep": 0, "source_frame": "ee_link",
                    "target_frame": "base_link",
                    "source_frame_offset_xyz": [0.1, 0.0, 0.0],
                    "target_frame_offset_xyz": [1.2, 0.9, 0.0],
                    "rot_coeffs": [0, 0, 0]}},
        {"type": "cart_vel",
         "params": {"link": "ee_link", "max_displacement": 0.2}},
    ],
    "costs": [{"type": "avoid_singularity",
               "params": {"link": "ee_link", "lambda": 1e-3,
                          "coeffs": 2.0}}],
    "init_info": {"type": "stationary"},
}

DYNAMIC_CART_DOC = {
    "basic_info": {"n_steps": 2, "manip": "m"},
    "constraints": [
        {"type": "dynamic_cart_pose",
         "params": {"timestep": 0, "source_frame": "ee_link",
                    "target_frame": "link_1",
                    "target_frame_offset_xyz": [1.8, 0.0, 0.0],
                    "target_frame_offset_wxyz": [0.9, 0.0, 0.0, 0.3],
                    "rot_coeffs": [0, 0, 0]}},
    ],
    "init_info": {"type": "stationary"},
}

TIME_DOC = {
    "basic_info": {"n_steps": 4, "manip": "m", "use_time": True,
                   "dt_lower_lim": 0.05, "dt_upper_lim": 5.0,
                   "fixed_timesteps": [0]},
    "costs": [{"type": "total_time", "params": {"coeff": 5.0}},
              {"type": "joint_acc", "params": {"coeffs": [1, 2]}}],
    "constraints": [
        {"type": "joint_vel",
         "params": {"upper_tols": [2.0, 2.0], "lower_tols": [-2.0, -2.0]}},
        {"type": "joint_pos",
         "params": {"targets": [3.0, 0.0], "first_step": 3,
                    "last_step": 3}},
    ],
    "init_info": {"type": "stationary", "dt": 1.0},
}

USER_DOC = {
    "basic_info": {"n_steps": 2, "manip": "manipulator"},
    "costs": [
        {"type": "joint_pos",
         "params": {"targets": [0.0, 0.0], "first_step": 0, "last_step": 1}},
        {"type": "user_defined",
         "params": {"error_function": "parity_prod", "penalty_type": 1,
                    "coeffs": 3.0}},
    ],
    "constraints": [
        {"type": "user_defined",
         "params": {"error_function": "parity_sum",
                    "jacobian_function": "parity_sum_jac",
                    "constraint_type": "eq", "fixed_steps": [0]}},
    ],
    "init_info": {"type": "given_traj", "data": [[2.0, 2.0], [1.0, 0.5]]},
}

PAIRS_DOC = {
    "basic_info": {"n_steps": 1, "manip": "manipulator"},
    "costs": [{"type": "joint_pos",
               "params": {"targets": [0.0, 0.0], "first_step": 0,
                          "last_step": 0}}],
    "constraints": [
        {"type": "collision",
         "params": {"coeffs": 1, "dist_pen": 0.2, "evaluator_type": 1,
                    "safety_margin_buffer": 0.05, "use_weighted_sum": True,
                    "pairs": [{"link": "ball", "pair": ["obstacle"],
                               "coeffs": 3.0, "dist_pen": 0.4}]}},
    ],
    "init_info": {"type": "given_traj", "data": [[-0.75, 0.75]]},
}

VECTOR_DOC = {
    "basic_info": {"n_steps": 3, "manip": "manipulator"},
    "costs": [{"type": "joint_vel", "params": {"coeffs": [1, 1]}}],
    "constraints": [
        {"type": "collision",
         "params": {"coeffs": [1, 1, 1], "dist_pen": [0.2, 0.3, 0.2],
                    "evaluator_type": 2,
                    "longest_valid_segment_length": 0.05}},
        {"type": "joint_pos",
         "params": {"targets": [-0.9, 0.9], "first_step": 0,
                    "last_step": 0}},
    ],
    "opt_info": {"max_iter": 7, "cnt_tolerance": 1e-3,
                 "trust_box_size": 0.5, "merit_coeff_increase_ratio": 5,
                 "inflate_constraints_individually": True},
    "init_info": {"type": "given_traj",
                  "data": [[-0.9, 0.9], [-0.8, 0.85], [-0.75, 0.8]]},
}


def _arm_table_doc():
    with open(ARM_TABLE) as f:
        return json.load(f)


DOCS = {
    "arm_table": (_arm_table_doc(), "arm7", jbench.ARM7_HOME),
    "simple_collision": (SIMPLE_COLLISION_DOC, "spherebot", None),
    "cast": (CAST_DOC, "boxbot", None),
    "cart": (CART_DOC, "rrbot", np.array([0.1, 0.1])),
    "dynamic_cart": (DYNAMIC_CART_DOC, "rrbot", np.array([0.7, 0.5])),
    "time": (TIME_DOC, "spherebot", np.array([0.0, 0.0])),
    "user": (USER_DOC, "boxbot", None),
    "pairs": (PAIRS_DOC, "spherebot", None),
    "vector": (VECTOR_DOC, "spherebot", None),
}


def _register_user_functions():
    juser.register_user_function("parity_prod")(
        lambda q, p: jnp.atleast_1d(q[0] * q[1] - 0.5))
    juser.register_user_function("parity_sum")(
        lambda q, p: jnp.atleast_1d(jnp.sum(q) - 1.0))
    juser.register_user_function("parity_sum_jac")(
        lambda q, p: jnp.ones((1, q.shape[0]), q.dtype))
    tuser.register_user_function("parity_prod")(
        lambda q, p: torch.atleast_1d(q[0] * q[1] - 0.5))
    tuser.register_user_function("parity_sum")(
        lambda q, p: torch.atleast_1d(q.sum() - 1.0))
    tuser.register_user_function("parity_sum_jac")(
        lambda q, p: torch.ones((1, q.shape[0]), dtype=q.dtype))


def _construct(pkg, name, doc=None):
    base, robot, state = DOCS[name]
    mod, env = _env(pkg, robot, state)
    doc = copy.deepcopy(base if doc is None else doc)
    if pkg == "jax":
        return mod.construct_problem(doc, env)
    return mod.construct_problem(doc, env, device="cpu")


@pytest.mark.parametrize("name", list(DOCS))
def test_parsed_problem_matches_jax(name):
    _register_user_functions()
    jp, tp = _construct("jax", name), _construct("torch", name)
    assert (tp.prob.n_steps, tp.prob.n_dof, tp.prob.use_time,
            list(tp.prob.fixed_steps)) == \
        (jp.prob.n_steps, jp.prob.n_dof, jp.prob.use_time,
         list(jp.prob.fixed_steps))
    assert [(t.name, t.kind.value, t.n_rows, t.band_width, t.n_groups)
            for t in tp.prob.term_sets] == \
        [(t.name, t.kind.value, t.n_rows, t.band_width, t.n_groups)
         for t in jp.prob.term_sets]
    for tt, jt in zip(tp.prob.term_sets, jp.prob.term_sets):
        if jt.band_starts is not None:
            np.testing.assert_array_equal(tt.band_starts, jt.band_starts)
        if jt.groups is not None:
            np.testing.assert_array_equal(tt.groups, jt.groups)
    # linspace rounds differently in the two packages (1 ulp)
    init = np.array(jp.init_traj)
    np.testing.assert_allclose(tp.init_traj.numpy(), init, rtol=0,
                               atol=1e-15)
    lb_j, ub_j = jp.prob.bounds(jnp.asarray(init).reshape(-1))
    lb_t, ub_t = tp.prob.bounds(tp.init_traj.reshape(1, -1))
    np.testing.assert_allclose(lb_t[0].numpy(), np.asarray(lb_j), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(ub_t[0].numpy(), np.asarray(ub_j), rtol=0,
                               atol=1e-15)
    assert tp.sqp == sqp_params_from_dict(dataclasses.asdict(jp.sqp))
    assert (tp.backend, tp.log_results) == (jp.backend, jp.log_results)
    # the rows at the init agree too
    x = init.reshape(1, -1)
    for tt, jt in zip(tp.prob.term_sets, jp.prob.term_sets):
        ref = np.atleast_1d(np.asarray(jax.jit(jt.fn)(jnp.asarray(x[0]),
                                                      {})))
        np.testing.assert_allclose(tt.fn(torch.as_tensor(x), {})[0].numpy(),
                                   ref, rtol=0, atol=1e-9, err_msg=tt.name)


def _edit(name, fn):
    doc = copy.deepcopy(DOCS[name][0])
    fn(doc)
    return name, doc


REJECTIONS = {
    "unknown_section": _edit("simple_collision",
                             lambda d: d.update(bogus_section={})),
    "unknown_term_param": _edit(
        "simple_collision",
        lambda d: d["costs"][1]["params"].update(nonsense=1)),
    "unknown_basic_info": _edit(
        "simple_collision", lambda d: d["basic_info"].update(colour=1)),
    "unknown_term_type": _edit(
        "simple_collision",
        lambda d: d["costs"].append({"type": "teleport", "params": {}})),
    "contact_test_type": _edit(
        "simple_collision",
        lambda d: d["constraints"][0]["params"].update(contact_test_type=1)),
    "num_threads": _edit("simple_collision",
                         lambda d: d.update(opt_info={"num_threads": 8})),
    "unknown_opt_info": _edit("simple_collision",
                              lambda d: d.update(opt_info={"tempo": 1})),
    "bad_given_traj": _edit(
        "simple_collision",
        lambda d: d["init_info"].update(data=[[0.0, 0.0, 0.0]])),
    "unknown_init": _edit("simple_collision",
                          lambda d: d["init_info"].update(type="magic")),
    "unknown_convex_solver": _edit(
        "simple_collision",
        lambda d: d["basic_info"].update(convex_solver="cplex")),
    "static_dynamic_target": _edit(
        "dynamic_cart",
        lambda d: d["constraints"][0]["params"].update(
            target_frame="base_link")),
    "dynamic_without_target": _edit(
        "dynamic_cart",
        lambda d: d["constraints"][0]["params"].pop("target_frame")),
    "unregistered_user_function": _edit(
        "user",
        lambda d: d["costs"][1]["params"].update(error_function="nowhere")),
    "bad_pair_entry": _edit(
        "pairs",
        lambda d: d["constraints"][0]["params"]["pairs"][0].update(pair=[])),
    "missing_dist_pen": _edit(
        "simple_collision",
        lambda d: d["costs"][0]["params"].pop("dist_pen")),
    "collision_without_scene": _edit(
        "cart", lambda d: d["constraints"].append(
            {"type": "collision", "params": {"dist_pen": 0.1}})),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejection_matches_jax(case):
    _register_user_functions()
    name, doc = REJECTIONS[case]
    with pytest.raises(Exception) as ej:
        _construct("jax", name, doc)
    with pytest.raises(Exception) as et:
        _construct("torch", name, doc)
    assert type(et.value) is type(ej.value), (et.value, ej.value)


def _result_fields(res, lane=None):
    pick = (lambda v: int(v)) if lane is None else (lambda v: int(v[lane]))
    return tuple(pick(getattr(res, f)) for f in
                 ("status", "n_iter", "n_qp_solves", "n_func_evals"))


def test_arm_table_solve_matches_jax(tmp_path):
    doc = _arm_table_doc()
    doc["opt_info"].update(log_results=True, log_dir=str(tmp_path))
    jp = _construct("jax", "arm_table", doc)
    jp.log_results = False
    tp = _construct("torch", "arm_table", doc)
    jres, tres = jp.solve(), tp.solve()
    assert _result_fields(tres, 0) == _result_fields(jres)
    assert int(jres.status) == 1
    np.testing.assert_allclose(tres.x[0].numpy(), np.asarray(jres.x),
                               rtol=0, atol=1e-6)
    log = (tmp_path / "trajopt_solver.log").read_text().splitlines()
    assert log[0] == "iteration,total_cost,max_viol,box_size"
    assert len(log) == int(tres.n_iter[0]) + 1
    vars_log = (tmp_path / "trajopt_vars.log").read_text().splitlines()
    assert len(vars_log[0].split(",")) == 1 + 70

    # the independent checker on the solution, and on the penetrating init
    env = _env("torch", "arm7")[1]
    jscene = jrobots.arm7_scene()
    # the JAX checker queries one state at a time; compile that query once
    jscene.distances = jax.jit(jscene.distances)
    trajs = np.stack([np.asarray(jres.x).reshape(10, 7),
                      np.asarray(jp.init_traj)])
    for substeps, margin in ((4, 0.0), (3, 0.015)):
        refs = [jax_check(jscene, t, margin=margin, substeps=substeps)
                for t in trajs]
        ok_b, d_b = check_trajectory(env.scene, torch.as_tensor(trajs),
                                     margin=margin, substeps=substeps)
        for i, (ok_j, d_j) in enumerate(refs):
            ok_t, d_t = check_trajectory(env.scene, trajs[i], margin=margin,
                                         substeps=substeps)
            assert ok_t == bool(ok_b[i]) == bool(ok_j)
            assert abs(d_t - d_j) <= 1e-9 and abs(float(d_b[i]) - d_j) <= 1e-9
        if margin == 0.0:
            # the solution is free, the straight-line init runs through
            # the post
            assert [bool(ok) for ok, _ in refs] == [True, False]


def test_bpmpd_takes_the_ipm_at_parity():
    doc = copy.deepcopy(SIMPLE_COLLISION_DOC)
    doc["basic_info"]["convex_solver"] = "BPMPD"
    jp = _construct("jax", "simple_collision", doc)
    tp = _construct("torch", "simple_collision", doc)
    assert tp.sqp.qp_algorithm == jp.sqp.qp_algorithm == "ipm"
    jres, tres = jp.solve(), tp.solve()
    assert int(jres.status) == 1
    assert _result_fields(tres, 0) == _result_fields(jres)
    np.testing.assert_allclose(tres.x[0].numpy(), np.asarray(jres.x),
                               rtol=0, atol=1e-6)


def test_native_backend_raises():
    """``convex_solver: native`` takes the host reference driver, as in the
    JAX package (it raised while the driver was not ported): the JAX test's
    check, the solve clears the constraint's 0.2 margin; an unknown backend
    still raises."""
    doc = copy.deepcopy(SIMPLE_COLLISION_DOC)
    doc["basic_info"]["convex_solver"] = "native"
    assert _construct("jax", "simple_collision", doc).backend == "native"
    tp = _construct("torch", "simple_collision", doc)
    assert tp.backend == "native"
    res = tp.solve()                  # parity: test_torch_reference_json.py
    assert res.status == 1
    scene = _env("torch", "spherebot")[1].scene
    d = scene.distances(scene.tree.fk(torch.as_tensor(res.x)))
    assert float(d.min()) >= 0.2 - 1e-3
    with pytest.raises(ValueError, match="backend"):
        tjson.JsonProblem(tp.prob, tp.init_traj, tp.sqp, backend="osqp")


def test_yaml_file_and_term_registry(tmp_path):
    """load_problem_file reads YAML (PyYAML, imported there only), and a
    registered term type hatches."""
    from trajopt_tpu_torch.sqp.nlp import Kind, TermSet

    @tjson.register_term_type("parity_sum_to")
    def _build(prob, env, params, is_cost, name):
        total = float(params["total"])
        prob.add_term(TermSet(name, Kind.CNT_EQ,
                              lambda x, p: x.sum(-1, keepdim=True) - total,
                              1))

    path = tmp_path / "prob.yaml"
    path.write_text("basic_info: {n_steps: 3, manip: m}\n"
                    "costs: [{type: joint_vel, params: {coeffs: [1, 1]}}]\n"
                    "constraints: [{type: parity_sum_to, "
                    "params: {total: 1.0}}]\n")
    _, env = _env("torch", "spherebot", np.array([0.5, 0.5]))
    tp = tjson.load_problem_file(str(path), env, device="cpu")
    res = tp.solve()
    assert int(res.status[0]) == 1
    assert abs(float(res.x.sum()) - 1.0) < 1e-4


def test_plots_and_plotters(tmp_path):
    from trajopt_tpu_torch.callbacks import (CartesianErrorPlotter,
                                             ClearPlotter, CollisionPlotter,
                                             CsvLogger, JointStatePlotter,
                                             chain, make_iteration_callback)
    from trajopt_tpu_torch.plotting import (plot_iterations,
                                            plot_trajectory_joints)
    tp = _construct("torch", "cast")
    scene = _env("torch", "boxbot")[1].scene
    logger = CsvLogger()
    joints = JointStatePlotter(3, 2, prefix=str(tmp_path / "joints_"))
    coll = CollisionPlotter(scene, 3, 2, prefix=str(tmp_path / "coll_"))
    cart = CartesianErrorPlotter(lambda x: x[2:4] - np.array([1.9, 0.0]),
                                 path=str(tmp_path / "cart.png"))
    clear_target = JointStatePlotter(3, 2)
    host = chain(logger, joints, coll, cart, clear_target,
                 ClearPlotter(clear_target))
    res = tp.prob.make_solve(tp.sqp, callback=make_iteration_callback(host))(
        tp.init_traj[None])
    n_iter = int(res.n_iter[0])
    assert int(res.status[0]) == 1 and len(logger.rows) == n_iter
    assert len(joints.history) == len(coll.history) == n_iter
    assert clear_target.history == []
    assert coll.history[0].shape == (3,)
    plot_iterations(logger, str(tmp_path / "convergence.png"), 3, 2)
    plot_trajectory_joints(res.x[0].reshape(3, 2),
                           str(tmp_path / "trajectory.png"), ["x", "y"])
    for f in ("convergence.png", "trajectory.png", "cart.png",
              "joints_000.png", "coll_000.png"):
        assert (tmp_path / f).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", f


def test_mpc_two_cycles_match_jax():
    from trajopt_tpu.sqp.params import SQPParams as JaxSQPParams
    n_steps = 10
    jprob, _ = jbench.arm_table_problem(n_steps=n_steps)
    tprob, _ = tbench.arm_table_problem(n_steps=n_steps, device="cpu")
    jsqp = JaxSQPParams()
    jstep = jax.jit(jax.vmap(jax_mpc_step(jprob, jsqp,
                                          reinit_goal_key="goal")))
    tstep = make_mpc_step(tprob, sqp_params_from_dict(
        dataclasses.asdict(jsqp)), reinit_goal_key="goal")
    goals = tbench.arm7_goals(2, 2)
    traj = np.asarray(tbench.arm_table_batch(2, 2, n_steps, device="cpu")[0])
    traj_j, traj_t = jnp.asarray(traj), torch.as_tensor(traj)
    for cycle in range(2):
        g = goals + 0.01 * cycle
        traj_j, jres = jstep(traj_j, {"goal": jnp.asarray(g)})
        traj_t, tres = tstep(traj_t, {"goal": g})
        for lane in range(2):
            assert _result_fields(tres, lane) == _result_fields(
                jax.tree.map(lambda v: v[lane], jres)), (cycle, lane)
        np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j),
                                   rtol=0, atol=1e-6)
    assert traj_t.shape == (2, n_steps, 7)
