"""The port's independent trajectory verifier
(``trajopt_tpu_torch/external_verify.py``) against the JAX package's
script (``benchmarks/external_verify.py``, loaded by file path) and the
JAX package's FK and exact pair distances, float64 on the CPU; no solve.
"""

import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision.world import scene_from_urdf as jscene_from_urdf
from trajopt_tpu.kinematics.chain import build_tree as jbuild_tree
from trajopt_tpu.kinematics.srdf import parse_srdf as jparse_srdf
from trajopt_tpu.kinematics.urdf import parse_urdf as jparse_urdf
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu_torch import external_verify as ev
from trajopt_tpu_torch.collision.sdf_grid import bake_sdf
from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models import robots as trobots

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_CONFIGS = 64
FK_TOL = 1e-12
EXACT_TOL = 1e-6


def _script():
    spec = importlib.util.spec_from_file_location(
        "external_verify_jax", REPO / "benchmarks" / "external_verify.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _script()


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    return trobots.write_mesh_arm(str(tmp_path_factory.mktemp("mesh_arm")))


def _trees(robot, mesh_dir):
    """(port tree, JAX tree, a configuration the seeded noise centres on)."""
    if robot == "pr2ish":
        return trobots.pr2ish(), jrobots.pr2ish(), tbench.PR2ISH_GOAL
    if robot == "arm7":
        return trobots.arm7(), jrobots.arm7(), tbench.ARM7_GOAL
    jmodel = jparse_urdf(trobots.MESH_ARM_URDF)
    return (trobots.mesh_arm_scene(mesh_dir).tree, jbuild_tree(jmodel),
            tbench.MESH_ARM_HOME)


@pytest.mark.parametrize("robot", ["pr2ish", "arm7", "mesh_arm"])
def test_fk_matches_script_and_jax(robot, script, mesh_dir):
    """The verifier's numpy FK on the port's tree against the script's on
    the JAX tree and against the JAX tree's own FK, 64 seeded
    configurations, to 1e-12."""
    tree, jtree, centre = _trees(robot, mesh_dir)
    Q = centre + 0.5 * np.random.default_rng(5).standard_normal(
        (N_CONFIGS, len(centre)))
    R, p = ev.numpy_fk(tree, Q)
    Rs, ps = script.numpy_fk(jtree, Q)
    Rj, pj = jax.jit(jax.vmap(jtree.fk))(jnp.asarray(Q))
    assert R.shape == (N_CONFIGS, len(tree.link_names), 3, 3)
    for got, ref in ((R, Rs), (p, ps), (R, np.asarray(Rj)),
                     (p, np.asarray(pj))):
        np.testing.assert_allclose(got, ref, rtol=0, atol=FK_TOL)


def _hull_pair(rng, offset):
    """Two seeded point clouds (10 and 14 points, radius ~0.2) whose
    centres lie ``offset`` apart."""
    a = 0.2 * rng.standard_normal((10, 3))
    b = 0.2 * rng.standard_normal((14, 3)) + offset * rng.standard_normal(3) \
        / np.sqrt(3.0)
    return a, b


@pytest.mark.parametrize("offset", [0.05, 0.3, 1.0, 2.5])
def test_exact_distance_matches_script(offset, script):
    """The exact hull distance against the script's on seeded hull pairs,
    overlapping (small offsets: 0 for both) and separated, to 1e-6; the
    signed distance equals it where the hulls are apart and is negative
    where they overlap."""
    rng = np.random.default_rng(int(offset * 100))
    for _ in range(3):
        a, b = _hull_pair(rng, offset)
        d = ev.exact_hull_distance(a, b)
        assert abs(d - script.exact_hull_distance(a, b)) <= EXACT_TOL
        s = ev.exact_signed_distance(a, b)
        if d > ev.TOUCH:
            assert s == d
        else:
            assert s < 0.0


@pytest.mark.parametrize("shift,dist", [((3.0, 0.5, 0.2), 1.0),
                                        ((0.3, 4.0, -1.0), 2.0),
                                        ((-0.4, 0.7, -3.2), 1.2)])
def test_unconverged_exact_distance_stays_below(shift, dist, script,
                                                monkeypatch):
    """Two cubes of half side 1 apart across a face (turned by one
    rotation; the distance is known) with SLSQP cut at 2 iterations: the
    script's value, SLSQP's own, lies above the distance, the verifier's
    exact and signed distances at or below it."""
    import scipy.optimize

    minimize = scipy.optimize.minimize

    def cut(*args, **kw):
        return minimize(*args, **{**kw, "options": {**kw["options"],
                                                    "maxiter": 2}})

    monkeypatch.setattr(scipy.optimize, "minimize", cut)
    c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], float)
    R = np.linalg.qr(np.random.default_rng(2).standard_normal((3, 3)))[0]
    a, b = c @ R.T, (c + shift) @ R.T
    assert script.exact_hull_distance(a, b) > dist + 1e-9
    assert 0.0 <= ev.exact_hull_distance(a, b) <= dist + 1e-12
    assert ev.exact_signed_distance(a, b) <= dist + 1e-12


@pytest.mark.parametrize("shift,depth", [((1.5, 0.2, 0.0), 0.5),
                                         ((0.3, 0.2, 0.1), 1.7),
                                         ((0.0, 1.9, -0.4), 0.1)])
def test_signed_distance_of_overlapping_boxes(shift, depth):
    """Two overlapping cubes of half side 1, axis-aligned (the depth is the
    least overlap over the axes) and both turned by one rotation: minus
    that depth, to 1e-6."""
    c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], float)
    R = np.linalg.qr(np.random.default_rng(2).standard_normal((3, 3)))[0]
    for rot in (np.eye(3), R):
        got = ev.exact_signed_distance(c @ rot.T, (c + shift) @ rot.T)
        assert abs(got + depth) <= EXACT_TOL


@pytest.mark.parametrize("unified", [False, True])
def test_certificates_below_jax_distances(unified):
    """Every pair's certificate at 64 seeded pr2ish configurations (around
    the goal, some pairs in collision) is at most the JAX package's pair
    distance (``CollisionScene.distances``, float64): the closed-form
    primitive narrowphase, or with ``unify_narrowphase`` GJK + SAT, whose
    SAT depth is exact only at face contacts, so there the pairs apart are
    held."""
    _, tscene = tbench.pr2ish_table_problem(n_steps=5, device="cpu",
                                            unify_narrowphase=unified)
    _, jscene = jbench.pr2ish_table_problem(n_steps=5,
                                            unify_narrowphase=unified)
    assert [(a.name, b.name) for a, b in tscene.pairs()] == \
        [(a.name, b.name) for a, b in jscene.pairs()]
    Q = tbench.PR2ISH_GOAL + 0.3 * np.random.default_rng(9).standard_normal(
        (N_CONFIGS, 8))
    cert = ev.pair_certificates(tscene, Q, device="cpu")
    ref = np.asarray(jax.jit(jax.vmap(jscene.distances))(jnp.asarray(Q)))
    assert cert.shape == ref.shape == (N_CONFIGS, len(tscene.pairs()))
    assert (ref < 0).any() and (cert > 0).mean() > 0.9
    held = ref > 0 if unified else np.ones_like(ref, bool)
    assert (cert[held] <= ref[held] + 1e-12).all(), \
        float((cert - ref)[held].max())


@pytest.mark.parametrize("robot", ["arm7", "mesh_arm"])
def test_pair_list_matches_jax(robot, mesh_dir):
    """The pairs the verifier checks (the port's ``scene.pairs()``, the
    scene's adjacency, allowed-collision and SRDF filter) are the JAX
    package's, pair for pair, on the arm7 table scene (arm7 dense) and the
    mesh arm's scene; pr2ish (flagship, hard mix, unified flagship) is held
    by the test above."""
    if robot == "arm7":
        tscene = tbench.arm_table_problem(n_steps=5, device="cpu")[1]
        jscene = jbench.arm_table_problem(n_steps=5)[1]
    else:
        tscene = trobots.mesh_arm_scene(mesh_dir)
        jmodel = jparse_urdf(trobots.MESH_ARM_URDF)
        jscene = jscene_from_urdf(jbuild_tree(jmodel), jmodel,
                                  jparse_srdf(trobots.MESH_ARM_SRDF),
                                  package_map={"mesh_arm": mesh_dir})
        jscene.add_world_box("post", *trobots.MESH_ARM_POST)
    names = [(a.name, b.name) for a, b in tscene.pairs()]
    assert names and names == [(a.name, b.name) for a, b in jscene.pairs()]


def test_planted_collision_flagged_by_both():
    """A lane whose straight line from home drives the forearm through the
    table top, beside a lane that stays clear (home, a small move of the
    roll joints): both the verifier and the port's ``swept_verify`` flag
    the first and pass the second, and the exact solver's deepest sample
    is near the swept check's."""
    _, scene = tbench.pr2ish_table_problem(n_steps=5, device="cpu")
    n = 12
    w = np.linspace(0.0, 1.0, n)[:, None]
    goal = tbench.pr2ish_goals(1, 2)[0]
    free_goal = tbench.PR2ISH_HOME + np.array([0, 0, 0, 0, 0, 0.3, 0, 0.3])
    traj = np.stack([tbench.PR2ISH_HOME * (1 - w) + g * w
                     for g in (goal, free_goal)])
    verdict = ev.certify(scene, traj, device="cpu", log=lambda m: None)
    mins = tbench.swept_verify(scene, torch.as_tensor(traj))
    out = verdict.agreement(mins)
    assert float(mins[0]) < 0 < float(mins[1])
    assert verdict.lane_min[0] < 0 < verdict.lane_min[1]
    assert out["agree"] == 2 and out["external_free"] == 1
    worst = min((e for e in verdict.exact if e[0] == 0), key=lambda e: e[2])
    assert "table_top" in worst[1]
    assert verdict.max_exact_penetration == pytest.approx(-worst[2])
    assert abs(worst[2] - float(mins[0])) < 0.01
    assert verdict.left_uncertified == 0 and out["diff_max"] <= 0.01
    # made tight below the swept value, the free lane's samples all lie
    # above it less 1e-3: the swept check does not over-state clearance
    assert verdict.lane_min[1] < float(mins[1]) - 1e-3
    lows, n_local, n_exact, left = verdict.refine([np.nan, float(mins[1])])
    assert n_local > 0 and left == 0
    assert lows[1] >= float(mins[1]) - 1e-3
    assert lows[0] == verdict.lane_min[0]


def test_center_param_geometry():
    """A world sphere registered with ``center_param`` takes its centre
    from ``params``, one a lane, as the scene does: arm7 held at home,
    the sphere far from it on one lane and on its wrist on the other;
    the tight clearances equal the scene's discrete distances there."""
    scene = trobots.arm7_scene(world_objects=False)
    scene.add_world_sphere("ball", 0.05, center_param="ball")
    tree = scene.tree
    R, p = ev.numpy_fk(tree, tbench.ARM7_HOME[None])
    wrist = p[0, tree.link_id("link_7")]
    centres = np.stack([wrist + [0.0, 0.0, 2.0], wrist + [0.03, 0.0, 0.0]])
    traj = np.repeat(tbench.ARM7_HOME[None, None], 3, 1).repeat(2, 0)
    verdict = ev.certify(scene, traj, {"ball": torch.as_tensor(centres)},
                         device="cpu", log=lambda m: None)
    assert verdict.lane_min[0] > 1.0 and verdict.lane_min[1] < 0.0
    lows, *_ = verdict.refine([np.inf, np.inf])
    fk = tree.fk(torch.as_tensor(tbench.ARM7_HOME[None].repeat(2, 0)))
    ref = scene.distances(fk, {"ball": torch.as_tensor(centres)})
    np.testing.assert_allclose(lows, ref.amin(-1).numpy(), rtol=0,
                               atol=EXACT_TOL)


def test_device_policy_and_sdf_pairs(monkeypatch):
    """Without ``device`` the certificates need the card and raise without
    one; an SDF world has no vertex form and raises with its name."""
    _, scene = tbench.pr2ish_table_problem(n_steps=5, device="cpu")
    traj = np.repeat(tbench.PR2ISH_HOME[None, None], 3, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ev.certify(scene, traj, log=lambda m: None)
    sdf = CollisionScene(trobots.arm7())
    sdf.add_link_sphere("link_7", 0.05)
    sdf.add_world_sdf("blob", bake_sdf(lambda x: x.norm(dim=-1) - 0.1,
                                       [-0.2] * 3, [0.2] * 3, 0.1))
    with pytest.raises(NotImplementedError, match="blob"):
        ev.certify(sdf, np.zeros((1, 2, 7)), device="cpu", log=lambda m: None)


def test_flagship_params_match_jax():
    """The entry point's solver settings (``flagship_params``, which
    ``chip_smoke.py`` solves its flagship paths with too) are the JAX
    package's ``__graft_entry__._solver_params("cast")``."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert dataclasses.asdict(tbench.flagship_params()) == \
        dataclasses.asdict(mod._solver_params("cast"))


def test_module_leaves_jax_out():
    """The verifier imports neither ``jax`` nor ``trajopt_tpu``."""
    code = ("import sys\n"
            "import trajopt_tpu_torch.external_verify\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'trajopt_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
