"""Benchmark problem builders: the pr2ish arm-around-table cast workload,
the arm7 table workload and the spherebot simple-collision problem.

Counterpart of ``trajopt_tpu/models/benchmarks.py`` (``pr2ish_table_problem``
with ``unify_narrowphase``, ``pr2ish_table_batch`` with its hard mix,
``pr2ish_restart_family``, ``arm_table_problem``, ``arm_table_batch`` and
``simple_collision_problem``), plus :func:`flagship_params`, the
flagship's solver settings, and :func:`swept_verify`,
the independent post-solve swept-clearance check of the repository's
``bench.py``.  Goals come from a numpy seed (the JAX builders draw them
with ``jax.random``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trajopt_tpu_torch import resolve_device, resolve_dtype
from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.models.robots import (arm7, arm7_scene, boxbot,
                                             mesh_arm_scene, pr2ish,
                                             pr2ish_scene)
from trajopt_tpu_torch.problem.trajectory import (TrajOptProblem,
                                                  interpolated_init)
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.sqp.params import SQPParams
from trajopt_tpu_torch.terms.collision import collision_term
from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel
from trajopt_tpu_torch.utils.profiling import host_read

ARM7_HOME = np.array([-0.5, 1.0, 0.0, -1.2, 0.0, 0.8, 0.0])
ARM7_GOAL = np.array([0.9, 1.0, 0.0, -1.2, 0.0, 0.8, 0.0])
# Goal noise per joint: small on the shoulder/elbow joints that place the
# arm relative to the post (keeps sampled goals collision-free), larger on
# the wrist joints.
ARM7_GOAL_SCALE = np.array([0.05, 0.03, 0.05, 0.05, 0.1, 0.1, 0.3])


def arm_table_problem(n_steps: int = 30, *, evaluator: str = "discrete",
                      margin: float = 0.025, coeff: float = 20.0,
                      lvs_substeps: int = 3, device=None,
                      ) -> tuple[TrajOptProblem, CollisionScene]:
    """7-DOF arm reaching across a table post: joint_vel smoothing cost,
    goal joint-pose equality constraint (params key ``'goal'``) and
    collision inequality constraints (8 pairs, all steps but the fixed
    first).  The problem solves on ``device`` (None: CUDA, raising when
    there is none)."""
    tree = arm7()
    scene = arm7_scene()
    prob = TrajOptProblem(n_steps=n_steps, n_dof=7, joint_lower=tree.lower,
                          joint_upper=tree.upper, fixed_steps=[0],
                          device=resolve_device(device))
    prob.add_term(joint_vel(n_steps, 7, is_cost=True, coeffs=np.full(7, 5.0)))
    prob.add_term(joint_pos(n_steps, 7, is_cost=False, targets="goal",
                            first_step=n_steps - 1, last_step=n_steps - 1))
    prob.add_term(collision_term(
        scene, n_steps, margin=margin, coeff=coeff, is_cost=False,
        evaluator=evaluator, fixed_steps=[0], lvs_substeps=lvs_substeps))
    return prob, scene


def arm7_goals(seed: int, batch: int) -> np.ndarray:
    """[batch, 7] goals: ARM7_GOAL plus seeded normal noise, clipped 0.05
    inside the joint limits."""
    noise = ARM7_GOAL_SCALE * np.random.default_rng(seed).standard_normal(
        (batch, 7))
    tree = arm7()
    return np.clip(ARM7_GOAL[None, :] + noise, tree.lower + 0.05,
                   tree.upper - 0.05)


def arm_table_batch(seed: int, batch: int, n_steps: int = 30, dtype=None,
                    device=None):
    """(inits [B, n_steps, 7], goals [B, 7]): randomized goals around
    ARM7_GOAL from a numpy seed and straight-line inits from ARM7_HOME, on
    ``device`` (None: CUDA, raising when there is none)."""
    return _table_batch(arm7_goals(seed, batch), ARM7_HOME, n_steps, dtype,
                        device)


PR2ISH_HOME = np.array([0.05, -1.9, 1.2, -1.0, -1.4, 0.0, -0.6, 0.0])
PR2ISH_GOAL = np.array([0.15, -0.3, 0.3, -0.5, -0.9, 0.0, -1.0, 0.0])
# Goal noise per joint: small on the joints that place the forearm relative
# to the table, large on the distance-insensitive roll joints.
PR2ISH_GOAL_SCALE = np.array([0.01, 0.02, 0.015, 0.03, 0.03, 0.2, 0.04,
                              0.3])
# Detour-forcing goal mode: the wrist ends under the table slab, inside its
# footprint, collision-free at the goal but with straight-line inits that
# drag the forearm through the table edge.
PR2ISH_GOAL_HARD = np.array([0.143, -0.158, 0.853, 0.644, -0.28, 1.399,
                             -1.347, -0.736])
# Borderline goal cluster of the hard mix: the wrist high over the table,
# collision-free at the goal; noisy lanes around these converge after
# several penalty escalations or run out of merit increases.
PR2ISH_GOALS_BORDERLINE = np.array([
    [0.1143, -0.5558, -0.1523, 0.0904, -0.5861, 1.357, -1.2312, 0.7872],
    [0.2411, 0.0659, -0.3671, -1.8761, -0.7197, 3.0094, -1.1766, -2.5179],
    [0.2331, -0.4895, -0.2305, -0.6582, -0.3882, -1.6229, -1.8168,
     -3.0383],
])
# Goal noise per joint of the borderline lanes.
PR2ISH_HARD_SCALE = np.array([0.01, 0.02, 0.02, 0.03, 0.03, 0.1, 0.04, 0.1])
# Vias of the restart family: the easy goal (straight-line reachable from
# home), then a torso-raised arm-up detour.
PR2ISH_RESTART_VIAS = np.array([
    PR2ISH_GOAL,
    [0.30, -0.3, -0.4, -0.5, -0.9, 0.0, -1.0, 0.0],
])


def flagship_params() -> SQPParams:
    """The flagship's solver settings, the JAX package's
    ``__graft_entry__._solver_params("cast")``: one restart, fixed rho,
    eps 2e-5, 450 ADMM iterations in chunks of 150, Ruiz 10, the
    Newton-Schulz refresh."""
    return dataclasses.replace(
        SQPParams(), max_restarts=1,
        qp=ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                      check_every=150, adaptive_rho=False,
                      rho_dual_scale=0.1, ruiz_iters=10, ns_refresh=True,
                      ns_tol=1e-4, ns_power_iters=4))


def pr2ish_table_problem(n_steps: int = 30, *, evaluator: str = "cast",
                         margin: float = 0.025, coeff: float = 20.0,
                         lvs_substeps: int = 3,
                         max_num_cnt: int | None = 16,
                         unify_narrowphase: bool = False, device=None,
                         ) -> tuple[TrajOptProblem, CollisionScene]:
    """PR2-class arm-around-table CAST workload: 8-DOF (torso lift + 7R
    arm), self-collision on, 91 candidate pairs; joint_vel smoothing cost,
    goal joint-pose equality constraint (params key ``'goal'``) and cast
    collision inequality constraints with the worst ``max_num_cnt`` rows
    per (gap, sub-segment).  ``unify_narrowphase`` routes every pair
    through the convex GJK + SAT kernel instead of the closed-form
    primitive kernels.  The problem solves on ``device`` (None: CUDA,
    raising when there is none)."""
    tree = pr2ish()
    scene = pr2ish_scene()
    scene.unify_narrowphase = unify_narrowphase
    prob = TrajOptProblem(n_steps=n_steps, n_dof=8, joint_lower=tree.lower,
                          joint_upper=tree.upper, fixed_steps=[0],
                          device=resolve_device(device))
    prob.add_term(joint_vel(n_steps, 8, is_cost=True, coeffs=np.full(8, 5.0)))
    prob.add_term(joint_pos(n_steps, 8, is_cost=False, targets="goal",
                            first_step=n_steps - 1, last_step=n_steps - 1))
    prob.add_term(collision_term(
        scene, n_steps, margin=margin, coeff=coeff, is_cost=False,
        evaluator=evaluator, fixed_steps=[0], lvs_substeps=lvs_substeps,
        max_num_cnt=max_num_cnt))
    return prob, scene


def pr2ish_goals(seed: int, batch: int, hard_frac: float = 0.0
                 ) -> np.ndarray:
    """[batch, 8] goals: PR2ISH_GOAL plus seeded normal noise, clipped
    0.02 inside the joint limits.  ``hard_frac`` gives the first
    ``ceil(hard_frac * batch)`` lanes the borderline goals instead (cycling
    through PR2ISH_GOALS_BORDERLINE) plus their own noise, drawn from a
    second generator derived from the seed (the JAX builder's
    ``fold_in(key, 1)``); the other lanes keep the goals ``hard_frac=0``
    gives."""
    noise = PR2ISH_GOAL_SCALE * np.random.default_rng(seed).standard_normal(
        (batch, 8))
    goals = PR2ISH_GOAL[None, :] + noise
    if hard_frac > 0.0:
        n_hard = int(np.ceil(hard_frac * batch))
        hnoise = PR2ISH_HARD_SCALE * np.random.default_rng(
            (seed, 1)).standard_normal((n_hard, 8))
        base = PR2ISH_GOALS_BORDERLINE[np.arange(n_hard)
                                       % len(PR2ISH_GOALS_BORDERLINE)]
        goals[:n_hard] = base + hnoise
    tree = pr2ish()
    return np.clip(goals, tree.lower + 0.02, tree.upper - 0.02)


def pr2ish_table_batch(seed: int, batch: int, n_steps: int = 30,
                       dtype=None, device=None, hard_frac: float = 0.0):
    """(inits [B, n_steps, 8], goals [B, 8]): randomized goals around
    PR2ISH_GOAL from a numpy seed (the first ``ceil(hard_frac * B)`` lanes
    on the borderline goals, see :func:`pr2ish_goals`) and straight-line
    inits from home, on ``device`` (None: CUDA, raising when there is
    none)."""
    return _table_batch(pr2ish_goals(seed, batch, hard_frac), PR2ISH_HOME,
                        n_steps, dtype, device)


def pr2ish_restart_family(goals: torch.Tensor, n_steps: int = 30,
                          rows: int = 1) -> torch.Tensor:
    """Multi-start restart family: ``[B, rows, n_steps, 8]`` alternative
    inits per lane, home -> via -> goal with the via at step
    ``n_steps // 2`` (row 0 through PR2ISH_GOAL, row 1 through the
    torso-raised detour), on ``goals``' device and dtype.  Pass it as
    ``params["restart_inits"]`` with ``SQPParams.max_restarts >= rows + 1``
    so that restart 0 stays in place.  As in the JAX builder, ``rows`` is
    cut to the two vias without notice."""
    goals = torch.as_tensor(goals)
    kw = dict(dtype=goals.dtype, device=goals.device)
    home = torch.as_tensor(PR2ISH_HOME, **kw).expand_as(goals)
    h = n_steps // 2
    out = []
    for via in PR2ISH_RESTART_VIAS[:rows]:
        via = torch.as_tensor(via, **kw).expand_as(goals)
        a = interpolated_init(home, via, h + 1)
        b = interpolated_init(via, goals, n_steps - h)
        out.append(torch.cat([a, b[:, 1:]], 1))
    return torch.stack(out, 1)


def simple_collision_problem(device=None
                             ) -> tuple[TrajOptProblem, CollisionScene]:
    """Spherebot simple-collision scene (simple_collision_test.json): one
    step pulled into the obstacle by a joint_pos cost, pushed out by a
    collision cost and constraint.  Solves on ``device`` (None: CUDA,
    raising when there is none)."""
    tree = boxbot()
    scene = CollisionScene(tree)
    scene.add_link_sphere("boxbot_link", 0.25)
    scene.add_world_box("obstacle", [0.5, 0.5, 0.5], [0.0, 0.0, 0.0])
    prob = TrajOptProblem(n_steps=1, n_dof=2, joint_lower=[-10, -10],
                          joint_upper=[10, 10], device=resolve_device(device))
    prob.add_term(collision_term(scene, 1, margin=0.3, coeff=1.0,
                                 is_cost=True))
    prob.add_term(collision_term(scene, 1, margin=0.2, coeff=1.0,
                                 is_cost=False))
    prob.add_term(joint_pos(1, 2, is_cost=True, targets=np.zeros(2),
                            first_step=0, last_step=0))
    return prob, scene


MESH_ARM_HOME = np.array([-1.2, 0.3])
MESH_ARM_GOAL = np.array([1.2, -0.3])


def mesh_arm_problem(directory: str, n_steps: int = 8, device=None
                     ) -> tuple[TrajOptProblem, CollisionScene]:
    """The mesh arm (``models/robots.py``, link meshes written to
    ``directory`` by ``write_mesh_arm``) swinging across its post:
    joint_vel cost, goal joint-pose constraint (params key ``'goal'``) and
    LVS-discrete collision constraints (margin 0.02, 4 sub-points a gap) on
    its hull-vs-box pairs.  The straight-line init runs through the post;
    the solve folds the elbow to pass it."""
    scene = mesh_arm_scene(directory)
    tree = scene.tree
    prob = TrajOptProblem(n_steps=n_steps, n_dof=2, joint_lower=tree.lower,
                          joint_upper=tree.upper, fixed_steps=[0],
                          device=resolve_device(device))
    prob.add_term(joint_vel(n_steps, 2, is_cost=True, coeffs=np.full(2, 5.0)))
    prob.add_term(joint_pos(n_steps, 2, is_cost=False, targets="goal",
                            first_step=n_steps - 1, last_step=n_steps - 1))
    prob.add_term(collision_term(scene, n_steps, margin=0.02, coeff=20.0,
                                 is_cost=False, evaluator="lvs_discrete",
                                 lvs_substeps=3, fixed_steps=[0]))
    return prob, scene


def _table_batch(goals: np.ndarray, home: np.ndarray, n_steps, dtype,
                 device):
    dev = resolve_device(device)
    dtype = resolve_dtype(dev, dtype)
    goals = torch.as_tensor(goals, dtype=dtype, device=dev)
    home = torch.as_tensor(home, dtype=dtype, device=dev)
    return interpolated_init(home.expand_as(goals), goals, n_steps), goals


def swept_verify(scene: CollisionScene, traj: torch.Tensor,
                 check_len: float = 0.05) -> torch.Tensor:
    """[B] minimum swept clearance per lane of ``traj [B, T, n_dof]``: every
    gap is cut into sub-segments no longer than ``check_len`` in joint
    space (the same count for all lanes, from the batch's longest step; the
    reference checkTrajectory's LONGEST_VALID_SEGMENT_LENGTH) and checked
    with ``swept_distances``.  A lane is collision-free when its value is
    > 0."""
    max_disp = host_read("collision", "verify", float,
                         torch.linalg.vector_norm(torch.diff(traj, dim=1),
                                                  dim=-1).max())
    n_sub = max(1, int(np.ceil(max_disp / check_len)))
    fr = torch.linspace(0.0, 1.0, n_sub + 1, dtype=traj.dtype,
                        device=traj.device)
    a, b = traj[:, :-1], traj[:, 1:]
    q = a[:, :, None, :] + fr[:, None] * (b - a)[:, :, None, :]
    with torch.no_grad():
        R, p = scene.tree.fk(q)
        d = scene.swept_distances((R[:, :, :-1], p[:, :, :-1]),
                                  (R[:, :, 1:], p[:, :, 1:]))
    return torch.amin(d.reshape(d.shape[0], -1), -1)
