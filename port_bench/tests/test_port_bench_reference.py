"""The reference against the port in float64 on the CPU: forward
kinematics, the pair distances at sampled configurations, and the problem
the harness builds from a configuration file against the port's own
builder (pairs, costs and violations)."""

import numpy as np
import pytest
import torch

from port_bench import goals, problem, spec
from port_bench.reference import arith, geometry, judge
from port_bench.reference.robot import Robot
from trajopt_tpu_torch.models import benchmarks as mb
from trajopt_tpu_torch.sqp import nlp as nlp_mod

BUILDERS = {"pr2ish_cast": lambda: mb.pr2ish_table_problem(
    30, lvs_substeps=2, device="cpu"),
    "arm7_dense": lambda: mb.arm_table_problem(30, device="cpu")}


def _q(robot, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = robot.lower, robot.upper
    return lo + (hi - lo) * rng.uniform(size=(n, robot.n_dof))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_fk_matches_the_port(name):
    cfg = spec.config(name)
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    _, scene = BUILDERS[name]()
    tree = scene.tree
    assert np.array_equal(robot.lower, tree.lower)
    assert np.array_equal(robot.upper, tree.upper)
    q = _q(robot, 64, 1)
    R, p = tree.fk(torch.as_tensor(q))
    poses = robot.fk(q)
    for i, link in enumerate(tree.link_names):
        assert np.abs(poses[link][0] - R[:, i].numpy()).max() < 1e-12
        assert np.abs(poses[link][1] - p[:, i].numpy()).max() < 1e-12


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_distances_match_the_port(name):
    cfg = spec.config(name)
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    _, scene = BUILDERS[name]()
    assert [[a.name, b.name] for a, b in scene.pairs()] == \
        cfg["scene"]["pairs"]
    q = _q(robot, 256, 2)
    poses = robot.fk(q)
    got = geometry.pair_distances(cfg["scene"], poses)
    R, p = scene.tree.fk(torch.as_tensor(q))
    want = scene.distances((R, p)).numpy()
    assert ((got > 0) == (want > 0)).all()
    sep = (got > 0) & (want > 0)
    assert np.abs(got[sep] - want[sep]).max() < 1e-9


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_capsule_box_definition_against_the_least_distance(name):
    """The system's capsule-box distance (a bracketed search) lies at or
    above the least distance, by at most about 2.4e-4 m here."""
    cfg = spec.config(name)
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    shapes = geometry.world_shapes(cfg["scene"], robot.fk(_q(robot, 256, 3)))
    over = []
    for a, b in cfg["scene"]["pairs"]:
        (ka, sa), (kb, sb) = shapes[a], shapes[b]
        if {ka, kb} != {"capsule", "box"}:
            continue
        (cap, box) = (sa, sb) if ka == "capsule" else (sb, sa)
        args = (arith.exact, cap[0], cap[1], *box)
        system = geometry.segment_box(*args)
        least = geometry.segment_box_exact(*args)
        clear = system > 0
        assert (least[clear] <= system[clear] + 1e-12).all()
        over.append((system - least)[clear])
    assert 0 < np.concatenate(over).max() < 5e-4


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                  -3.0 - 2.0**-12])
    assert arith.tf32(x).tolist() == [1.0 + 2.0**-10, 1.0,
                                      1.0 + 2.0**-9, -3.0]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_problem_from_the_configuration_is_the_ports(name):
    cfg = spec.config(name)
    prob, scene, _ = problem.build(cfg, torch.device("cpu"))
    want_prob, want_scene = BUILDERS[name]()
    assert [(a.name, b.name) for a, b in scene.pairs()] == \
        [(a.name, b.name) for a, b in want_scene.pairs()]
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    g = goals.goals(cfg["goals"], robot.lower, robot.upper, (5,), 3)
    x = torch.as_tensor(goals.straight_inits(cfg["goals"]["home"], g, 30)
                        + 0.01 * np.random.default_rng(5).standard_normal(
                            (3, 30, robot.n_dof))).reshape(3, -1)
    params = {"goal": torch.as_tensor(g)}
    a, b = prob.build(), want_prob.build()
    assert torch.equal(nlp_mod.eval_exact_costs(a, x, params),
                       nlp_mod.eval_exact_costs(b, x, params))
    assert torch.equal(nlp_mod.eval_exact_cnt_viols(a, x, params),
                       nlp_mod.eval_exact_cnt_viols(b, x, params))
    xr = x.reshape(3, 30, -1).numpy()
    assert np.allclose(judge.cost(cfg, xr),
                       nlp_mod.eval_exact_costs(a, x, params)[:, 0].numpy(),
                       rtol=1e-14, atol=0)
    goal_groups = [gs for t, _, gs in nlp_mod.cnt_group_structure(a)
                   if t.name == "joint_pos"][0]
    assert np.allclose(judge.goal_residual(cfg, xr, g),
                       nlp_mod.eval_exact_cnt_viols(a, x, params)
                       [:, goal_groups].sum(-1).numpy(), rtol=1e-14, atol=0)


def test_solver_settings_are_given_in_full():
    sqp = problem.solver_params(spec.config("pr2ish_cast"))
    assert sqp == mb.flagship_params()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_least_distances_are_exact_below_the_cut(name, monkeypatch):
    """With ``least_below`` the least distance is the float64 search's
    wherever it lies below the cut, and above the cut elsewhere."""
    cfg = spec.config(name)
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    poses = robot.fk(_q(robot, 512, 4))
    for cut in (0.0, 0.025, 0.2):
        system, least = geometry.pair_distances(cfg["scene"], poses,
                                                least_below=cut)
        assert np.array_equal(system,
                              geometry.pair_distances(cfg["scene"], poses))
        with monkeypatch.context() as m:
            m.setattr(geometry, "segment_box", geometry.segment_box_exact)
            exact = geometry.pair_distances(cfg["scene"], poses)
        below = exact < cut
        assert below.any()
        assert np.array_equal(least[below], exact[below])
        assert (least[~below] >= cut).all()


def test_constraint_points_of_each_evaluator():
    x = np.random.default_rng(6).standard_normal((2, 5, 3))
    q, lane = judge.constraint_points(
        {"evaluator": "discrete", "fixed_steps": [0]}, x)
    assert np.array_equal(q, x[:, 1:].reshape(-1, 3))
    assert lane.tolist() == [0] * 4 + [1] * 4
    q, lane = judge.constraint_points(
        {"evaluator": "cast", "fixed_steps": [0], "lvs_substeps": 2}, x)
    assert q.shape == (2 * 4 * 3, 3) and lane.tolist() == [0] * 12 + [1] * 12
    assert np.allclose(q[1], 0.5 * (x[0, 0] + x[0, 1]), rtol=0, atol=1e-15)
    assert np.array_equal(q[11], x[0, 4])


def test_guarantees_of_a_trajectory():
    """Joint-limit excess, goal rows and collision rows, recomputed from
    the trajectory alone."""
    cfg = spec.config("pr2ish_cast")
    robot = Robot(str(spec.ROOT / cfg["urdf"]))
    g = goals.goals(cfg["goals"], robot.lower, robot.upper, (8,), 2)
    x = goals.straight_inits(cfg["goals"]["home"], g, 30)
    assert judge.limit_excess(robot, x).tolist() == [0.0, 0.0]
    x[1, 7, 0] = robot.lower[0] - 0.05
    assert judge.limit_excess(robot, x)[1] == pytest.approx(0.05)
    assert judge.goal_rows(cfg, x, g).max() == 0.0
    assert judge.goal_rows(cfg, x, g + 1e-3) == pytest.approx([1e-3] * 2)
    rows = judge.collision_rows(cfg, robot, x)
    (term,) = [t for t in cfg["terms"] if t["type"] == "collision"]
    q, lane = judge.constraint_points(term, x)
    least = judge.least_distances(cfg, robot, q)[1]
    for s in range(2):
        assert rows[s] == pytest.approx(
            term["coeff"] * (term["margin"] - least[lane == s].min()))
