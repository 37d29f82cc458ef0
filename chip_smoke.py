"""Smoke run of the PyTorch/CUDA port (``trajopt_tpu_torch``) on one card.

Phases, each of which must pass:

1. the card: its name and power limit, the torch/CUDA versions and the
   TF32 settings (all off);
2. build the hand-written kernels ``csrc/admm_block_chunk.cu``,
   ``csrc/admm_dense_chunk.cu``, ``csrc/convex_narrowphase.cu`` and
   ``csrc/primitive_narrowphase.cu`` with nvcc, all at once (``-Xptxas
   -v``: registers and spills, one line an instantiation);
3. hold the block kernel against its plain PyTorch version at the
   flagship QP shapes (T 30, D 8, K 2, R 40, B 256, 150 iterations), on
   seeded data with hard, penalty and inert padded rows and one lane with
   a planted NaN, and on the flagship's first QP; time both versions on
   the latter and compute the bound and the cluster design's floor; print
   the cluster size, the shared memory per block and how many clusters
   the card holds at once;
4. hold the dense kernel against its plain version at the arm7 shapes
   (n 210, m 449, B 128, 20 iterations), on seeded data with hard,
   equality, penalty and box rows, a planted NaN lane and an ``active``
   mask, and on the arm7 path's first QP; time both versions on the
   latter and compute the bound and the cluster design's floor; print the
   cluster size, the shared memory per block and how many clusters the
   card holds at once; one adaptive-rho ``solve_qp`` of that QP on the
   card against float64;
4b. hold the convex search kernel against its plain version on every
   call of the unified flagship's first convexification (B = 256,
   float32; the largest call, the swept moving-vs-static group of 697,856
   queries, in float64 too): the queries whose selection differs and the
   distance each gives, and each call's GJK steps to the fixed point
   (``fused_convex.gjk_steps``); time both on the largest call and compute
   the bound from the steps its queries run;
4c. hold the primitive narrowphase kernel against its plain version on
   every primitive call of the flagship's first convexification and first
   exact evaluation (B = 256: the swept Jacobian call and the swept value
   call, 1,351,168 queries each; float32, the largest call in float64
   too; one kernel launch a group): the queries whose d or J differ
   beyond tolerance and the largest differences; time both on the
   largest call and compute the bound;
5. small problems (10 steps, 3 lanes) on the card (float32, kernels,
   the primitive narrowphase included) against the CPU (plain versions):
   for pr2ish one QP step (convexify, prepare, 450 ADMM iterations)
   against float64, and a whole solve of each path (pr2ish block, arm7
   dense) against float32: statuses equal, counts inside the CPU's own
   range under 1e-6 changes of the inits, x where the counts match
   (:func:`hold_in_cpu_range`);
6. the flagship: the cast solve (pr2ish, 30 steps, LVS 2, B = 256 lanes)
   through ``pr2ish_table_problem`` / ``TrajOptProblem.make_solve(...,
   structured=True)``, then the independent swept check of every lane;
   the block kernel's launch count over that solve; a profiled repeat for
   the device's idle share, the chunk kernel's in-path time and the
   primitive kernel's traced launches and query calls (one launch a
   group, a call's launches back to back); the final trajectories
   re-verified
   with the plain primitive narrowphase (the same verified count); the
   same batch solved with the plain primitive narrowphase (eager) against
   the kernel route: in float32 statuses equal on >= 99 % of the lanes
   and the median |dx| of converged lanes with equal counts within 4x the
   plain route's own median move under 1e-6 changes of the inits (the
   lanes beyond 1e-3 counted); in float64 (plain chunks, eager) statuses
   on >= 99 % and converged x within 1e-3; an eager profiled solve for the
   narrowphase's device time (``collision.primitive``) and its top
   kernels;
7. the arm7 discrete workload (30 steps, B = 128 lanes) through
   ``arm_table_problem`` / ``make_solve(discrete_params())`` on the dense
   QP path, the same checks with the dense kernel's launch count and the
   primitive kernel's discrete launches (required); then
   the same workload on the block path (``structured=True``, its cluster
   size printed), counts and rate only;
8. the flagship's hard mix (``bench.py``'s second line): the flagship
   problem and settings on B = 256 lanes of which the first 64 have
   borderline detour goals (``hard_frac=0.25``), through the same checks
   as phase 6, with the status and iteration histograms, the counts of
   the hard lanes and the largest merit coefficient;
9. the hard mix again with ``max_restarts=2`` and the multi-start family
   ``pr2ish_restart_family(goals, 30, rows=1)`` as
   ``params["restart_inits"]``: counts, re-seeded lanes and the block
   kernel's launches;
10. the JSON front end on arm7: (a) the port's ``arm_table.json`` through
   ``load_problem_file`` and ``JsonProblem.solve()`` with its CSV logs,
   converged and free under ``check_trajectory``; (b) the Cartesian-reach
   document (:func:`reach_document`, 30 steps, ``cart_pose`` and
   ``lvs_discrete``, the documents' default settings) on B = 128 lanes
   through ``jp.prob.make_solve(jp.sqp)``: per-lane status, pose error and
   ``check_trajectory`` (20 sub-states a gap, margin 0), verified lanes,
   rate, the dense kernel's launches and a profiled repeat; (c) the dense
   kernel (a cluster of 5 at n 210, m 888) on that path's first QP against
   its plain version, its time, bound and resident clusters; (d) three MPC
   cycles of the arm7 workload (B = 128, goal +0.01 rad a cycle).
11. the rest of the collision world: (a) the flagship under
   ``unify_narrowphase`` (``pr2ish_table_problem(..., unify_narrowphase=
   True)``: all 91 pairs through the convex GJK + SAT narrowphase and its
   search kernel, B = 256, block path; the kernel's launches over the
   first solve, which makes the captures) through the same checks as
   phase 6, verified with the
   primitive scene's swept check, its distances held against the
   primitive kernels' on the result (waypoints: within 5e-4 where the
   primitive value is > -0.02; the LVS sub-segments reported), and the
   profiled repeat's device time inside the convex narrowphase
   (``collision.convex``; ``scripts/compare_trees.py`` prints it beside
   a parent tree's) with its top kernels, no sort kernel among them, and
   the search kernel's traced launches; (b)
   the unified scene's
   ``distances_and_jac`` and ``swept_distances_and_jac`` on the card in
   float64 against the CPU (and float32 beside the CPU's own float32
   error), and with the search kernel against the plain search (d within
   1e-10, Jacobians within 1e-8); (c) small float32 solves on the dense
   path (the mesh arm's hull pairs through the search kernel, with the
   GJK steps its queries run to their fixed points), card against CPU
   with equal statuses: arm6 on its shelf, the mesh arm (hulls of binary
   STL links written to a temporary directory, through
   ``scene_from_urdf`` with an SRDF), arm7 against an SDF grid of its
   table scene, and ``simple_collision_problem``.
12. the ifopt and host paths: (a) the PR2 planning problem built through
   the ifopt component model (:func:`ifopt_pr2_problem`: pr2ish, 30
   ``NodesVariables`` nodes of 8 ``position`` variables, the start pinned
   by its bounds, a squared ``JointVelConstraint`` cost, a
   ``JointPosConstraint`` goal and 29 ``ContinuousCollisionConstraint``s,
   LVS 2, 3 rows a gap; n 240, m 335 on the dense path), solved once
   through ``Problem.solve()`` and on B = 64 noisy starts through
   ``make_solver(problem.build())``, swept-verified, with the dense
   kernel's launches, plan and time on the path's first QP (held against
   its plain version) and a profiled repeat; (b) ``solve_reference`` (the
   host driver: convexify on the card, the native C++ QP on the host) on
   (a)'s problem against (a)'s single solve; (c) the batch split of
   ``parallel/mesh.py`` over every visible card on ``arm_table_problem(10)``
   at B = 32 against the unsplit solve; (d) ``utils/profiling.trace``
   around (c)'s solve (a Chrome trace with kernel events) and ``Timer``;
   (e) ``dump_failed_qps`` on a solve cut at one SQP iteration and a
   checkpoint round trip.
13. captured against eager: the flagship, the hard mix and arm7 dense,
   each solved on one seeded batch under ``utils.aot_cache.eager()`` and
   with the solver's regions captured as CUDA graphs, through the checks
   of phase 6 (wall time, verified solves/s, statuses, the chunk kernel's
   launches, captures and replays, a profiled repeat's idle share and
   layer split); statuses may differ on
   at most 1 % of the flagship and arm7 lanes and converged lanes' x by
   1e-3 (the hard mix is held to its verified limit); then phase 5's small
   references captured in float64 against the CPU, to 1e-9.
14. the external check: the final trajectories of the flagship (phase
   6), arm7 dense (7), the hard mix (8), the unified flagship (11 (a))
   and the mesh arm's small solve (11 (c)), each certified by
   ``trajopt_tpu_torch/external_verify.py`` (numpy FK, its own vertex
   forms, 0.025 rad samples, support-function certificates on the card,
   scipy's exact distances on the host; nothing of the solver's FK or
   narrowphase) and held against the swept check (``swept_verify``, the
   hand kernels): the script's JSON fields a path, the swept check less
   the tight sampled clearance (within 1e-3 m), and the phase's time.
   Fails on a swept-verified lane with a sample the exact solver finds
   more than 1e-3 m deep, on fewer lanes certified free than the path's
   limit (243/256, 122/128; the mesh arm's lanes cross its post, in the
   JAX package too, so there: every lane the swept check verifies, and
   the same verdict on every lane).  Phase 8 prints the index and status
   of every lane that does not converge.

Phases 6-12 run captured (the solver captures on the card); each measured
solve follows a warm-up on the same batch, which makes its captures, and
prints the captures and replays it made itself.

Phase 5 also holds, card (float32) against CPU: a borderline-goal pr2ish
solve that escalates its penalties, with and without the saturated-dual
rescale, and an arm7 solve on the IPM QP (both against float32), the IPM
on the arm7 path's first QP (against float64, beside the CPU's float32
under 1e-6 changes of the constraint matrix) and the gather-banded ADMM on
the pr2ish first QP's rows (against float64), and the JSON references of
:func:`hold_json_references`.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The verifier alone on the card (the flagship solved on 100 lanes, 30 %
on borderline goals, then certified; ``BENCH_LVS`` sets the LVS
sub-steps):

    python3 -m trajopt_tpu_torch.external_verify 100

and its CPU test (float64, against the JAX package's script and FK):
``python -m pytest tests/test_torch_external_verify.py``.

The last line of standard output is ``{"ok": true, "device": ...}``; the
line before it lists the kernels with their launches, errors and times.
Exits non-zero, printing no result line, on any failure and when no CUDA
device is present.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from trajopt_tpu_torch import external_verify as ev
from trajopt_tpu_torch import ifopt
from trajopt_tpu_torch.collision import convex as cvx
from trajopt_tpu_torch.collision import fused_convex as fc
from trajopt_tpu_torch.collision import fused_primitive as fp
from trajopt_tpu_torch.collision.check import check_trajectory
from trajopt_tpu_torch.collision.geometry import point_box_sdf
from trajopt_tpu_torch.collision.sdf_grid import bake_sdf
from trajopt_tpu_torch.kinematics.transforms import transform_error
from trajopt_tpu_torch.models.benchmarks import (ARM7_GOAL,
                                                 ARM7_GOAL_SCALE, ARM7_HOME,
                                                 MESH_ARM_GOAL,
                                                 MESH_ARM_HOME,
                                                 PR2ISH_HOME,
                                                 arm_table_batch,
                                                 arm_table_problem,
                                                 flagship_params,
                                                 mesh_arm_problem,
                                                 pr2ish_goals,
                                                 pr2ish_restart_family,
                                                 pr2ish_table_batch,
                                                 pr2ish_table_problem,
                                                 simple_collision_problem,
                                                 swept_verify)
from trajopt_tpu_torch.models.robots import (arm6, arm6_scene, arm7,
                                             arm7_scene, pr2ish,
                                             pr2ish_scene, write_mesh_arm)
from trajopt_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                             make_sharded_batch_solver,
                                             summarize)
from trajopt_tpu_torch.problem.json_io import (Environment,
                                               construct_problem,
                                               load_problem_file)
from trajopt_tpu_torch.problem.mpc import make_mpc_step
from trajopt_tpu_torch.problem.trajectory import (TrajOptProblem,
                                                  interpolated_init)
from trajopt_tpu_torch.qp import admm as dense
from trajopt_tpu_torch.qp import block_banded as bb
from trajopt_tpu_torch.qp import fused_block as fb
from trajopt_tpu_torch.qp import fused_dense as fd
from trajopt_tpu_torch.qp.admm import ADMMConfig
from trajopt_tpu_torch.qp.inverse import cholesky_inverse
from trajopt_tpu_torch.qp.admm_block import (chunk_operands,
                                             prepare_qp_block,
                                             solve_qp_block_prepared)
from trajopt_tpu_torch.qp.admm_structured import solve_qp_structured
from trajopt_tpu_torch.qp.ipm import solve_qp_ipm
from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.reference_solver import solve_reference
from trajopt_tpu_torch.sqp.solver import (banded_qp, block_qp, build_qp,
                                          ipm_config, make_solver,
                                          num_qp_rows)
from trajopt_tpu_torch.terms.collision import collision_term
from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel
from trajopt_tpu_torch.utils import aot_cache, profiling
from trajopt_tpu_torch.utils.checkpoint import load_result, save_result
from trajopt_tpu_torch.utils.debug import dump_failed_qps
from trajopt_tpu_torch.utils.profiling import Timer, trace

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Shared memory per SM and clock: 32 banks of 4 bytes, each serving one
# access a clock (CUDA C++ Programming Guide, "Compute Capabilities",
# shared memory of compute capability 5.x and later: "each bank has a
# bandwidth of 32 bits per clock cycle"); times the SM count and the
# maximum SM clock read from the card.  Used only for the printed design
# floors of phases 3 and 4.
SMEM_BYTES_PER_CLK = 32 * 4
# The kernel wrappers' launch counters (``utils/profiling.py``'s registry;
# a replay of a captured region counts its launches again).
BLOCK_LAUNCHES = "qp.block_chunk.launches"
DENSE_LAUNCHES = "qp.dense_chunk.launches"
CONVEX_LAUNCHES = "collision.convex.launches"
PRIMITIVE_LAUNCHES = "collision.primitive.launches"
PRIMITIVE_KERNELS = "collision.primitive.kernels"

T, D, K, R, B, N_ITERS = 30, 8, 2, 40, 256, 150
# Kernel vs plain version, both float32 on the same inputs: they sum in
# another order (warp shuffles and shared-memory loops against batched
# GEMM and tensor reductions), and over 150 iterations the rounding grows
# past what a fixed relative bound can state -- the dual residual is a
# difference of terms ~20x its size.  So both are held against the plain
# version in float64 on the same (float32) inputs: the kernel's distance
# to it may be at most CHUNK_NOISE times the float32 plain version's own
# distance, plus CHUNK_FLOOR of the quantity's magnitude.
CHUNK_NOISE = 4.0
CHUNK_FLOOR = 1e-6
# Card (float32, kernel) against CPU (float64, plain version) on one small
# QP step: float32 convexification (inputs rounded at ~1e-7) and 450 ADMM
# iterations of float32 rounding, which the kernel check above measures at
# ~1e-4 of the state's magnitude per 150 iterations; 1e-3 of the
# solution's magnitude allows for that and still flags any wrong update.
SMALL_XTOL = 1e-3
# Card against CPU on a whole float32 solve (10 steps, 3 lanes): equal
# status and counts, and x within the bound the CPU test holds the port's
# float32 solve to against the JAX package's (two float32 solves summing
# in another order over 2 SQP steps and up to 900 ADMM iterations, on
# trajectories of magnitude ~2).
SOLVE_XTOL = 1e-4
# Draws of 1e-6 changes of the inits over which the CPU's own float32
# range is taken for phase 5's small solves (:func:`hold_in_cpu_range`).
SMALL_PERTURBATIONS = 6
MIN_VERIFIED = 243          # of 256 lanes: 95 %
# The arm7 discrete workload: B = 128 lanes of 30 steps; n = 210 variables,
# m = 449 dense QP rows (232 collision, 7 goal, 210 box).
ARM_B, ARM_STEPS = 128, 30
ARM_MIN_VERIFIED = 122      # of 128 lanes: 95 %
# The hard mix: the first ceil(0.25 * 256) = 64 lanes on borderline goals.
HARD_FRAC = 0.25
# bench.py's SQP iteration histogram edges.
ITER_EDGES = (0, 3, 5, 9, 17, 33)
# The borderline seed of the small float32 references: lanes 0 and 1
# escalate to 100 and 1000 with and without the rescale, and under 1e-6
# changes of the inits the CPU's float32 counts stay within one SQP
# iteration (lane 0 takes 4 or 5).  Most borderline seeds do not (a 3e-6
# change moves an escalation or a restart).
HARD_SMALL_SEED = 37


ARM_TABLE_JSON = (Path(__file__).resolve().parent / "trajopt_tpu_torch"
                  / "data" / "config" / "arm_table.json")
# The arm7 Cartesian-reach document of phase 10 at full width: 30 steps;
# its LVS count (2 sub-segments, 3 sub-points a gap, from the init's
# largest gap) makes 28 gaps x 3 x 8 pairs = 672 collision rows, plus 6
# pose and 210 box rows.
REACH_STEPS, REACH_B = 30, 128


def _wxyz(R: np.ndarray) -> list[float]:
    """Unit quaternion (w, x, y, z) of a rotation matrix."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2]))
                    / 2, R[2, 1] - R[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2]))
                    / 2, R[0, 2] - R[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2]))
                    / 2, R[1, 0] - R[0, 1])
    return [float(v) for v in (w, x, y, z)]


def reach_pose() -> tuple[np.ndarray, np.ndarray]:
    """(R, p) of ``tool0`` at ARM7_GOAL: the port's float64 FK."""
    tree = arm7()
    R, p = tree.fk(torch.as_tensor(ARM7_GOAL, dtype=torch.float64))
    i = tree.link_id("tool0")
    return R[i].numpy(), p[i].numpy()


def reach_document(n_steps: int) -> dict:
    """The arm7 Cartesian-reach problem document: joint_vel smoothing
    (coeffs 5), ``tool0`` at the FK pose of ARM7_GOAL at the last step
    (cart_pose), lvs_discrete collision constraints (dist_pen 0.025,
    coeffs 20, from step 1), start pinned, a straight-line init to
    ARM7_GOAL, and no opt_info (the documents' default settings)."""
    R, p = reach_pose()
    return {
        "basic_info": {"n_steps": n_steps, "manip": "arm7",
                       "fixed_timesteps": [0]},
        "costs": [{"type": "joint_vel", "name": "smooth",
                   "params": {"coeffs": [5] * 7}}],
        "constraints": [
            {"type": "cart_pose", "name": "reach",
             "params": {"source_frame": "tool0", "timestep": n_steps - 1,
                        "xyz": [float(v) for v in p], "wxyz": _wxyz(R)}},
            {"type": "collision", "name": "no_collision",
             "params": {"evaluator_type": 2, "dist_pen": 0.025,
                        "coeffs": 20, "first_step": 1}}],
        "init_info": {"type": "joint_interpolated",
                      "endpoint": [float(v) for v in ARM7_GOAL]},
        "opt_info": {},
    }


def arm7_env() -> Environment:
    return Environment(arm7(), arm7_scene(), ARM7_HOME)


def pose_error(tree, traj: torch.Tensor, step: int) -> torch.Tensor:
    """[B] norm of the ``tool0`` pose error against :func:`reach_pose` at
    ``step`` of ``traj [B, T, 7]``."""
    R_t, p_t = (torch.as_tensor(v, dtype=traj.dtype, device=traj.device)
                for v in reach_pose())
    R, p = tree.fk(traj[:, step])
    i = tree.link_id("tool0")
    return torch.linalg.vector_norm(
        transform_error(R_t, p_t, R[:, i], p[:, i]), dim=-1)


def discrete_params() -> SQPParams:
    """The JAX discrete workload's ``__graft_entry__._solver_params(
    "discrete")``: fixed rho, 60 iterations in chunks of 20, eps 2e-5,
    rho_dual_scale 0.1, Ruiz 10, one restart (the NS refresh acts on the
    block path only)."""
    return dataclasses.replace(
        SQPParams(), max_restarts=1,
        qp=ADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=60,
                      check_every=20, adaptive_rho=False,
                      rho_dual_scale=0.1, ruiz_iters=10, ns_refresh=True,
                      ns_tol=1e-4, ns_power_iters=4))


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi("name,power.limit")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    print(f"TF32: matmul {tf32[0]}, cudnn {tf32[1]}, float32 matmul "
          f"precision {tf32[2]!r}")
    if tf32 != (False, False, "highest"):
        raise SystemExit("TF32 must be off")
    return smi


def phase_build():
    """The four kernels at once, one nvcc each (``-Xptxas -v``: registers,
    shared memory and spills of each)."""
    t0 = time.time()
    mods = (fb, fd, fc, fp)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda mod: mod.build(verbose=True), mods))
    print(f"built {', '.join(m.SOURCE.name for m in mods)} for sm_90a in "
          f"{time.time() - t0:.1f} s")


def chunk_inputs(seed: int, dev):
    """Seeded QP data at the flagship shapes, built in float64: an SPD
    P, the x-update matrix M = P + sigma I + C'R C + rho_b diag(b^2) and
    its inverse, 32 weighted rows per step (4 hard, c = inf, two of them
    equalities with rho 100; 28 finite penalty rows, half of them
    equalities) and 8 inert padded rows (W = 0, l = -inf, u = +inf,
    c = 0), no rows past step T - K.  Returns (args, kw, live rows) for
    ``fb.chunk_*`` with args in float32."""
    rng = np.random.default_rng(seed)
    n, m, KD = T * D, T * R, K * D
    f64 = dict(dtype=torch.float64, device=dev)
    slot = np.arange(R)[None, :]
    live = np.zeros((T, R), bool)
    live[:T - K + 1, :32] = True
    Wb = rng.standard_normal((B, T, R, KD)) * live[None, :, :, None]
    hard = (live & (slot < 4)).reshape(-1)
    eq = (live & (slot % 2 == 0)).reshape(-1)
    live = live.reshape(-1)
    bnd = rng.standard_normal((B, m))
    lc = np.where(eq, bnd, -np.inf)
    uc = np.where(live, bnd, np.inf)
    c = np.where(hard, np.inf,
                 np.where(live, rng.uniform(1, 50, (B, m)), 0.0))
    rho_c = np.broadcast_to(np.where(hard & eq, 100.0, 0.1), (B, m)).copy()
    cr = np.where(np.isinf(c), np.inf, c / rho_c)
    A = rng.standard_normal((B, n, n)) / np.sqrt(n)
    P = A @ A.transpose(0, 2, 1) + np.eye(n)
    bd = rng.uniform(0.5, 1.5, (B, n))
    sigma, alpha, rho_b = 1e-6, 1.6, 0.1
    Wt = torch.as_tensor(Wb, **f64)
    C = bb.BlockBanded(Wb=Wt, plan=bb.BlockPlan(
        T=T, D=D, K=K, R=R, m=0, w=KD, blk_index=np.zeros(0, np.int64),
        scatter_idx=np.zeros(0, np.int64)))
    M = (torch.as_tensor(P, **f64) + sigma * torch.eye(n, **f64)
         + bb.at_r_a(C, torch.as_tensor(rho_c, **f64))
         + torch.diag_embed(torch.as_tensor(rho_b * bd * bd, **f64)))
    Minv = torch.linalg.inv(M)
    x = torch.as_tensor(rng.standard_normal((B, n)) * 0.1, **f64)
    yc = torch.as_tensor(rng.standard_normal((B, m)) * 0.01 * live, **f64)
    q = torch.as_tensor(rng.standard_normal((B, n)), **f64)
    q[7, 5] = float("nan")                      # the planted-NaN lane
    f = [Minv, Wt, torch.as_tensor(P, **f64), q,
         torch.as_tensor(lc, **f64), torch.as_tensor(uc, **f64),
         torch.as_tensor(cr, **f64), torch.as_tensor(rho_c, **f64),
         torch.as_tensor(-rng.uniform(0.1, 1, (B, n)), **f64),
         torch.as_tensor(rng.uniform(0.1, 1, (B, n)), **f64),
         torch.as_tensor(bd, **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B, m)), **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B, n)), **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B, n)), **f64),
         torch.as_tensor(rng.uniform(0.5, 2, (B,)), **f64),
         x, bb.matvec_wb(Wt, x, D), torch.as_tensor(bd, **f64) * x, yc,
         torch.zeros(B, n, **f64)]
    args = [t.to(torch.float32).contiguous() for t in f]
    kw = dict(D=D, sigma=sigma, alpha=alpha, rho_b=rho_b, n_iters=N_ITERS)
    return args, kw, live


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_qp(n_steps: int, lanes: int, seed: int, dev):
    """The main path's first QP for a pr2ish problem (LVS 2) on ``lanes``
    seeded lanes: convexified at the straight-line inits with the initial
    merit coefficients, equilibrated and factored as the solver does.
    Returns (prepared QP, trust-box lb, ub (0.1 around x), x)."""
    prob, _ = pr2ish_table_problem(n_steps=n_steps, lvs_substeps=2,
                                   device=dev)
    nlp = prob.build()
    inits, goals = pr2ish_table_batch(seed, lanes, n_steps, device=dev)
    x = inits.reshape(lanes, -1)
    params = {"goal": goals}
    lb, ub = prob.bounds(x)
    model = nlp_mod.convexify_structured(
        nlp, x, params, nlp_mod.linear_jacobians(nlp, x, params))
    plan = bb.make_plan(*nlp_mod.structured_band(nlp), *nlp.block)
    coeffs = x.new_full((lanes, nlp_mod.num_cnt_groups(nlp)), 10.0)
    prep = prepare_qp_block(block_qp(nlp, plan, model, coeffs, x),
                            flagship_params().qp)
    return (prep, torch.maximum(lb, x - 0.1), torch.minimum(ub, x + 0.1),
            x)


def hold(label: str, names, got, plain, ref) -> float:
    """Kernel outputs ``got`` and the float32 plain version's ``plain``
    against the float64 plain version's ``ref`` on the same float32
    inputs; prints, per quantity, its magnitude and each one's absolute
    and relative error.  Returns max |kernel - float32 plain|."""
    max_abs = 0.0
    for name, a, b, r in zip(names, got, plain, ref):
        if not (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.isnan(a), torch.isnan(r))):
            raise SystemExit(f"{label}: NaN pattern of {name} differs "
                             f"between kernel and plain")
        ok = ~torch.isnan(r)
        r = r[ok]
        mag = float(r.abs().max())
        err = float((a[ok] - b[ok]).abs().max())
        err_k = float((a[ok].double() - r).abs().max())
        err_p = float((b[ok].double() - r).abs().max())
        tol = CHUNK_NOISE * err_p + CHUNK_FLOOR * mag
        rel = max(mag, 1e-30)
        print(f"{label} {name:6s}: max |r| {mag:.3e}; against float64: "
              f"kernel {err_k:.3e} (rel {err_k / rel:.2e}), float32 plain "
              f"{err_p:.3e} (rel {err_p / rel:.2e}), tolerance {tol:.3e}; "
              f"max |kernel - plain| {err:.3e}")
        if not err_k <= tol:
            raise SystemExit(f"{label}: kernel disagrees with plain on "
                             f"{name}: {err_k:.3e} > {tol:.3e}")
        max_abs = max(max_abs, err)
    return max_abs


def hold_chunk(label: str, args, kw):
    """The block kernel against its plain version (see :func:`hold`).
    Returns (kernel outputs, max |kernel - float32 plain|)."""
    (st_k, stats_k) = fb.chunk_cuda(*args, **kw)
    (st_p, stats_p) = fb.chunk_plain(*args, **kw)
    (st_r, stats_r) = fb.chunk_plain(*[a.double() for a in args], **kw)
    torch.cuda.synchronize()
    names = ("x", "zc", "zb", "yc", "yb", "pri", "dua", "ax_n", "z_n",
             "pAty_n")
    max_abs = hold(label, names, (*st_k, *stats_k), (*st_p, *stats_p),
                   (*st_r, *stats_r))
    return (st_k, stats_k), max_abs


def smem_ms(nbytes: int) -> tuple[float, int, float]:
    """(ms to read ``nbytes`` from shared memory on every SM at its peak
    rate, the SM count, the maximum SM clock in Hz)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clk = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return nbytes / (n_sm * SMEM_BYTES_PER_CLK * clk) * 1e3, n_sm, clk


def bound(flops: int, nbytes: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, ms of the operations at the fp32 peak, ms
    of the bytes at the HBM rate)."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_ops, t_bytes)


def phase_kernel_check(dev) -> dict:
    args, kw, live = chunk_inputs(0, dev)
    (st_k, stats_k), err_syn = hold_chunk("seeded", args, kw)
    nan_lane = 7
    if not (torch.isnan(stats_k.pri[nan_lane])
            and torch.isnan(stats_k.dua[nan_lane])):
        raise SystemExit("the planted NaN did not reach pri/dua: a blown-up "
                         "QP would read as converged")
    others = torch.arange(B, device=dev) != nan_lane
    if torch.isnan(torch.stack(stats_k)[:, others]).any():
        raise SystemExit("NaN leaked into other lanes")
    pad = torch.as_tensor(~live, device=dev)
    if (st_k[1][others][:, pad] != 0).any() or \
            (st_k[3][others][:, pad] != 0).any():
        raise SystemExit("padded inert rows moved")
    print(f"planted NaN lane {nan_lane}: pri {float(stats_k.pri[nan_lane])}, "
          f"dua {float(stats_k.dua[nan_lane])} (not converged, as in JAX); "
          f"padded rows stay 0")

    consts, state = chunk_operands(*first_qp(T, B, 0, dev))
    args = [t.contiguous() for t in (*consts, *state)]
    cfg = flagship_params().qp
    kw = dict(D=D, sigma=cfg.sigma, alpha=cfg.alpha, rho_b=cfg.rho,
              n_iters=cfg.check_every)
    _, err_main = hold_chunk("main-path", args, kw)
    ms = cuda_ms(lambda: fb.chunk_cuda(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: fb.chunk_plain(*args, **kw), 3)
    flops = fb.chunk_flops(args[1], D, kw["n_iters"])
    n_out = sum(a.numel() for a in args[15:]) + 5 * B
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * n_out
    bound_ms, bound_by, t_ops, t_bytes = bound(flops, nbytes)
    cs, smem = fb.cluster_plan(T, D, K, R)
    clusters = fb.max_active_clusters(T, D, K, R)
    # The cluster design's floor: Minv read from shared memory once per
    # iteration, plus one load of Minv and the weights from device memory.
    minv = args[0].numel() * 4
    floor_smem, n_sm, clk = smem_ms(kw["n_iters"] * minv)
    floor_load = (minv + args[1].numel() * 4) / PEAK_HBM_BYTES * 1e3
    floor_ms = floor_smem + floor_load
    print(f"block kernel: clusters of {cs} blocks, {smem} B of shared "
          f"memory per block, at most {clusters} clusters resident "
          f"(cudaOccupancyMaxActiveClusters) -> {B / clusters:.2f} waves "
          f"of {B} problems")
    print(f"chunk on the main path's first QP, B={B}, {kw['n_iters']} "
          f"iterations: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP -> "
          f"{t_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms); "
          f"design floor {floor_ms:.4f} ms (Minv from shared memory "
          f"{kw['n_iters'] * minv / 1e9:.2f} GB on {n_sm} SMs x "
          f"{SMEM_BYTES_PER_CLK} B/clk at {clk / 1e6:.0f} MHz -> "
          f"{floor_smem:.4f} ms, plus one load of Minv and Wb "
          f"{floor_load:.4f} ms)")
    return {"name": "admm_block_chunk", "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/admm_block_chunk.cu",
            "replaces": "trajopt_tpu/qp/pallas_block.py:182",
            "max_abs_err": max(err_syn, err_main), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the chunk
            "library_ms": None}


def dense_chunk_inputs(seed: int, dev):
    """Seeded dense QPs at the arm7 shapes (B 128, n 210, m 449), built in
    float64: SPD P; 239 constraint rows -- 7 hard equalities (rho 100),
    then a seeded mix of hard inequalities, penalty inequalities and
    penalty equalities (c in [1, 50]) -- and 210 hard box rows; Minv of
    the matching x-update system; lane 5 with a planted NaN.  Returns
    (args in float32, kw) for ``fd.chunk_*``."""
    rng = np.random.default_rng(seed)
    n, m = 210, 449
    m_c = m - n
    f64 = dict(dtype=torch.float64, device=dev)
    A = np.concatenate([rng.standard_normal((ARM_B, m_c, n)) / np.sqrt(n),
                        np.broadcast_to(np.eye(n), (ARM_B, n, n))], 1)
    kind = rng.integers(0, 3, (ARM_B, m_c))   # hard ineq / soft ineq / soft eq
    kind[:, :7] = 3                           # hard equalities
    bnd = rng.standard_normal((ARM_B, m_c))
    l = np.concatenate([np.where(kind >= 2, bnd, -np.inf),
                        np.full((ARM_B, n), -1.0)], 1)
    u = np.concatenate([bnd, np.full((ARM_B, n), 1.0)], 1)
    c = np.concatenate([np.where((kind == 0) | (kind == 3), np.inf,
                                 rng.uniform(1, 50, (ARM_B, m_c))),
                        np.full((ARM_B, n), np.inf)], 1)
    rho = np.where(np.isinf(c) & (u - l < 1e-10), 100.0, 0.1)
    G = rng.standard_normal((ARM_B, n, n)) / np.sqrt(n)
    At = torch.as_tensor(A, **f64)
    M = (torch.as_tensor(G @ G.transpose(0, 2, 1) + np.eye(n), **f64)
         + 1e-6 * torch.eye(n, **f64)
         + At.transpose(1, 2) @ (torch.as_tensor(rho, **f64)[..., None]
                                 * At))
    x = rng.standard_normal((ARM_B, n)) * 0.1
    q = rng.standard_normal((ARM_B, n))
    q[5, 2] = np.nan                          # the planted-NaN lane
    f = [cholesky_inverse(M), At] + [torch.as_tensor(v, **f64) for v in (
        q, l, u, c / rho, rho, x, np.einsum("bmn,bn->bm", A, x),
        rng.standard_normal((ARM_B, m)) * 0.01)]
    kw = dict(sigma=1e-6, alpha=1.6, n_iters=discrete_params().qp.check_every)
    return [t.to(torch.float32).contiguous() for t in f], kw


def arm7_first_qp(n_steps: int, lanes: int, seed: int, dev):
    """The arm7 dense path's first QP on ``lanes`` seeded lanes:
    convexified at the straight-line inits with the initial merit
    coefficients, trust box 0.1 around x.  Returns (QPData, x)."""
    prob, _ = arm_table_problem(n_steps=n_steps, device=dev)
    nlp = prob.build()
    inits, goals = arm_table_batch(seed, lanes, n_steps, device=dev)
    x = inits.reshape(lanes, -1)
    params = {"goal": goals}
    lb, ub = prob.bounds(x)
    model = nlp_mod.convexify(nlp, x, params,
                              nlp_mod.linear_jacobians(nlp, x, params))
    coeffs = x.new_full((lanes, nlp_mod.num_cnt_groups(nlp)),
                        discrete_params().initial_merit_error_coeff)
    return build_qp(nlp, model, coeffs, torch.maximum(lb, x - 0.1),
                    torch.minimum(ub, x + 0.1)), x


def hold_dense(label: str, args, kw):
    """The dense kernel against its plain version (see :func:`hold`).
    Returns (kernel outputs, max |kernel - float32 plain|)."""
    got = fd.chunk_cuda(*args, **kw)
    plain = fd.chunk_plain(*args, **kw)
    ref = fd.chunk_plain(*[a.double() for a in args], **kw)
    torch.cuda.synchronize()
    return got, hold(label, ("x", "z", "y", "Ax"), got, plain, ref)


def phase_dense_kernel_check(dev) -> dict:
    args, kw = dense_chunk_inputs(0, dev)
    got, err_syn = hold_dense("dense seeded", args, kw)
    nan_lane = 5
    others = torch.arange(ARM_B, device=dev) != nan_lane
    if not all(bool(torch.isnan(t[nan_lane]).all()) for t in got):
        raise SystemExit("dense: the planted NaN did not fill its lane")
    if any(bool(torch.isnan(t[others]).any()) for t in got):
        raise SystemExit("dense: NaN leaked into other lanes")
    active = torch.arange(ARM_B, device=dev) % 3 != 0
    masked = fd.chunk(*args, **kw, active=active)

    def same(a, b):        # bit-equal, NaN where NaN
        return torch.equal(torch.nan_to_num(a, nan=7.0),
                           torch.nan_to_num(b, nan=7.0))

    for new, old, full in zip(masked[:3], args[7:], got[:3]):
        if not (same(new[~active], old[~active])
                and same(new[active], full[active])):
            raise SystemExit("dense: the active mask changed a skipped lane "
                             "or an active one")
    print(f"dense planted NaN lane {nan_lane}: all outputs NaN, none "
          f"elsewhere; active mask: skipped lanes unchanged, active lanes "
          f"bit-equal to the unmasked launch")

    cfg = discrete_params().qp
    qp, x0 = arm7_first_qp(ARM_STEPS, ARM_B, 0, dev)
    args = dense.chunk_operands(qp, x0, cfg)
    _, err_main = hold_dense("dense main-path", args, kw)
    ms = cuda_ms(lambda: fd.chunk_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: fd.chunk_plain(*args, **kw), 5)
    n_iters = kw["n_iters"]
    bound_ms, bound_by, t_ops, t_bytes = bound(
        fd.chunk_flops(args[1], n_iters), fd.chunk_bytes(args[1]))
    B, m, n = args[1].shape
    cs, smem = fd.cluster_plan(n, m)
    clusters = fd.max_active_clusters(n, m)
    # The cluster design's floor: A and Minv read from shared memory once
    # per iteration (A once more before the first), plus one load of both
    # from device memory.
    mats = fd.chunk_stream_bytes(args[1], n_iters)
    floor_smem, n_sm, clk = smem_ms(mats)
    floor_load = 4 * (args[0].numel() + args[1].numel()) / PEAK_HBM_BYTES \
        * 1e3
    floor_ms = floor_smem + floor_load
    print(f"dense kernel: clusters of {cs} blocks (0: the streaming kernel), "
          f"{smem} B of shared memory per block, at most {clusters} "
          f"clusters resident (cudaOccupancyMaxActiveClusters) -> "
          f"{B / clusters:.2f} waves of {B} problems")
    print(f"dense chunk on the arm7 path's first QP, B={B}, n={n}, m={m}, "
          f"{n_iters} iterations: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
          f"ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({fd.chunk_flops(args[1], n_iters) / 1e9:.3f} GFLOP -> "
          f"{t_ops:.4f} ms, {fd.chunk_bytes(args[1]) / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms); design floor {floor_ms:.4f} ms (A and Minv "
          f"from shared memory {mats / 1e9:.3f} GB on {n_sm} SMs x "
          f"{SMEM_BYTES_PER_CLK} B/clk at {clk / 1e6:.0f} MHz -> "
          f"{floor_smem:.4f} ms, plus one load of A and Minv "
          f"{floor_load:.4f} ms)")

    # The adaptive-rho path (a refactorization per chunk) launches the
    # kernel too: the path's 60 iterations (3 chunks, eps 0 so that all
    # run) on the card against float64 on the CPU.  Each rho step makes M
    # worse conditioned, and the float32 factorization loses digits with
    # it: the CPU's float32 plain path is 3e-4 from float64 here (1e-3 at
    # 100 iterations), within SMALL_XTOL of the magnitude.
    acfg = dataclasses.replace(cfg, adaptive_rho=True, eps_abs=0.0,
                               eps_rel=0.0)
    profiling.reset()
    res = dense.solve_qp(qp, x0, cfg=acfg)
    torch.cuda.synchronize()
    launches = _count(DENSE_LAUNCHES)
    ref = dense.solve_qp(dense.QPData(*(t.double().cpu() for t in qp)),
                         x0.double().cpu(), cfg=acfg)
    dx = float((res.x.double().cpu() - ref.x).abs().max())
    tol = SMALL_XTOL * max(1.0, float(ref.x.abs().max()))
    print(f"adaptive-rho solve_qp of that QP ({acfg.max_iter} "
          f"iterations): {launches} kernel launches; card float32 vs CPU "
          f"float64 max |dx| {dx:.3e}, tolerance {tol:.3e}")
    if launches <= 0:
        raise SystemExit("the adaptive-rho solve did not launch the kernel")
    if not dx <= tol:
        raise SystemExit(f"adaptive-rho solve: card and CPU differ by "
                         f"{dx:.3e}")
    return {"name": "admm_dense_chunk", "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/admm_dense_chunk.cu",
            "replaces": "trajopt_tpu/qp/pallas_admm.py:31",
            "max_abs_err": max(err_syn, err_main), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the chunk
            "library_ms": None}


# The convex search kernel against its plain version on the card.  Both
# make the same operations in the same order (explicit fma where the plain
# version calls addcmul), so a query whose selection differs is a near
# tie: two candidates (subsets, support vertices, SAT axes) equal up to
# rounding.  Such a query's distance may move by the tie's size, at most
# CONVEX_TIE_TOL in float32 (scenes of metres; the certificate's own
# threshold is 1e-4 x scale) and F64_D_TOL in float64.
CONVEX_TIE_TOL = 1e-5
F64_D_TOL, F64_J_TOL = 1e-10, 1e-8


def convex_main_inputs(dev) -> list:
    """The search's inputs on the unified flagship's first convexification
    (B = 256 straight-line inits, seed 0), one tuple per call."""
    prob, _ = unified_problem(device=dev)
    nlp = prob.build()
    inits, goals = pr2ish_table_batch(0, B, 30, device=dev)
    x = inits.reshape(B, -1)
    params = {"goal": goals}
    calls = []
    search = fc.select

    def record(*args):
        calls.append(tuple(t.detach().clone() for t in args[:5]))
        return search(*args)

    fc.select = record
    try:
        nlp_mod.convexify_structured(
            nlp, x, params, nlp_mod.linear_jacobians(nlp, x, params))
    finally:
        fc.select = search
    return calls


def hold_selection(label: str, inputs) -> float:
    """Kernel against plain search on ``inputs``: the queries whose
    selection differs, and the distances both give through the epilogue
    (radii 0).  Fails when a distance differs by more than the tie
    tolerance of the dtype; returns max |difference| of lam, z and d."""
    got = fc.select_cuda(*inputs)
    ref = fc.select_plain(*inputs)
    diff = torch.zeros(got.k.shape[:-1], dtype=torch.bool, device=got.k.device)
    for a, b in zip(got, ref):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.dtype.is_floating_point else a == b
        diff |= ~same.reshape(*diff.shape, -1).all(-1)
    Va, Vb, axes, _, cax = inputs
    d = [cvx._epilogue(Va, 0.0, Vb, 0.0, axes, cax, sel) for sel in (got, ref)]
    dd = (d[0] - d[1]).abs()
    errs = [float((got.lam - ref.lam).abs().max()),
            float((got.z - ref.z).abs().max()), float(dd.max())]
    n_diff = int(diff.sum())
    tol = CONVEX_TIE_TOL if Va.dtype == torch.float32 else F64_D_TOL
    print(f"{label}: {diff.numel()} queries, {n_diff} selections differ "
          f"(max |dd| among them "
          f"{float(dd[diff].max()) if n_diff else 0.0:.3e}, tie tolerance "
          f"{tol:.0e}); max |dlam| {errs[0]:.3e}, |dz| {errs[1]:.3e}, |dd| "
          f"{errs[2]:.3e}")
    if not errs[2] <= tol:
        raise SystemExit(f"{label}: the kernel's distances differ from the "
                         f"plain search's by {errs[2]:.3e}")
    return max(errs)


def print_gjk_steps(label: str, steps: torch.Tensor) -> None:
    """The distribution of ``steps`` (``fused_convex.gjk_steps``): how many
    queries the search kernel stops after each step count."""
    counts = torch.bincount(steps.flatten(), minlength=cvx.GJK_ITERS + 1)
    hist = {s: n for s, n in enumerate(counts.tolist()) if n}
    print(f"{label}: GJK steps to the fixed point (at most "
          f"{cvx.GJK_ITERS}): queries by steps {hist}, mean "
          f"{float(steps.double().mean()):.3f}")


def phase_convex_kernel_check(dev) -> dict:
    """The convex search kernel on the unified flagship's first
    convexification at B = 256: every call's inputs held against the plain
    search (float32, and the largest call in float64), the largest call
    (the swept moving-vs-static group) timed beside the plain search, with
    its bound."""
    calls = convex_main_inputs(dev)
    errs = []
    for i, inp in enumerate(calls):
        Va, Vb, axes = inp[:3]
        label = (f"convex search call {i} (queries {tuple(Va.shape[:-2])}, "
                 f"A {Va.shape[-2]}, B {Vb.shape[-2]}, K {axes.shape[-2]} "
                 f"+ 2)")
        errs.append(hold_selection(label, inp))
        print_gjk_steps(label, fc.gjk_steps(Va, Vb))
    main = max(calls, key=lambda c: c[0][..., 0, 0].numel() * c[2].shape[-2])
    f64 = tuple(t.double() if t.is_floating_point() else t for t in main)
    hold_selection("convex search, largest call, float64", f64)
    print_gjk_steps("convex search, largest call, float64",
                    fc.gjk_steps(*f64[:2]))
    Va, Vb, axes = main[:3]
    N = Va[..., 0, 0].numel()
    A, Bv, K = Va.shape[-2], Vb.shape[-2], axes.shape[-2]
    ms = cuda_ms(lambda: fc.select_cuda(*main), 20)
    plain_ms = cuda_ms(lambda: fc.select_plain(*main), 2)
    # the GJK steps this call's queries run to their fixed points
    flops = fc.search_flops(A, Bv, K, fc.gjk_steps(Va, Vb))
    nbytes = fc.select_bytes(*main)
    bound_ms, bound_by, t_ops, t_bytes = bound(flops, nbytes)
    print(f"convex search kernel on the largest call, {N} queries (A {A}, "
          f"B {Bv}, K {K} + 2): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP "
          f"-> {t_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms); "
          f"roofline share {bound_ms / ms:.2%}")
    return {"name": "convex_select", "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/convex_narrowphase.cu",
            "replaces": "trajopt_tpu/collision/convex.py:255",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the search
            "library_ms": None}


# The primitive narrowphase kernel against its plain version on the card.
# Both round every value alike (the same operations in the same order,
# --fmad=false), and the Jacobians differ only by the rounding of forward
# against reverse mode, except at near ties whose side rounding picks:
# segment_box's 17-sample scan and golden steps, where a flipped bracket
# moves t* and with it the Jacobian.  Float32 allows that on PRIM_FRAC of
# the queries (|dd| > PRIM_D32 or |dJ| > PRIM_J32); float64 on none (|dd|
# <= PRIM_D64, |dJ| <= PRIM_J64 on every query).
PRIM_D32, PRIM_J32, PRIM_FRAC = 1e-5, 1e-4, 1e-3
PRIM_D64, PRIM_J64 = 1e-12, 1e-9


def primitive_main_inputs(dev) -> list:
    """(scene, kind, endpoint poses, params, outputs) of every primitive
    narrowphase call of the flagship's first convexification and first
    exact evaluation (B = 256 straight-line inits, seed 0)."""
    prob, _ = pr2ish_table_problem(n_steps=30, lvs_substeps=2, device=dev)
    nlp = prob.build()
    inits, goals = pr2ish_table_batch(0, B, 30, device=dev)
    x = inits.reshape(B, -1)
    params = {"goal": goals}
    calls = []
    query = fp.query

    def record(scene, kind, fks, prm, outs):
        calls.append((scene, kind, fks, prm, len(outs)))
        return query(scene, kind, fks, prm, outs)

    fp.query = record
    try:
        nlp_mod.convexify_structured(
            nlp, x, params, nlp_mod.linear_jacobians(nlp, x, params))
        nlp_mod.eval_exact_costs(nlp, x, params)
        nlp_mod.eval_exact_cnt_viols(nlp, x, params)
    finally:
        fp.query = query
    return calls


def primitive_outputs(call, dtype=None):
    """(plan, endpoint poses, kernel outputs, plain outputs) of a recorded
    call, in ``dtype`` (default the call's)."""
    scene, kind, fks, prm, n_out = call
    if dtype is not None:
        fks = tuple(tuple(t.to(dtype) for t in f) for f in fks)
    like = fks[0][0]
    plan = fp.plan_of(scene, kind, like)
    got = scene._outputs(kind, like, n_out - 1)
    fp.query_cuda(plan, fks, prm, got)
    ref = fp.query_plain(scene, plan, fks, prm,
                         scene._outputs(kind, like, n_out - 1))
    return plan, fks, got, ref


def hold_primitive(label: str, call, dtype=None) -> float:
    """Kernel against plain on one recorded call: the queries whose d or J
    differ beyond the dtype's tolerance, the largest differences; fails
    past the allowance.  Returns max |kernel - plain| over d and J."""
    _, _, got, ref = primitive_outputs(call, dtype)
    torch.cuda.synchronize()
    f64 = got[0].dtype == torch.float64
    d_tol, j_tol = (PRIM_D64, PRIM_J64) if f64 else (PRIM_D32, PRIM_J32)
    if not torch.equal(torch.isnan(got[0]), torch.isnan(ref[0])):
        raise SystemExit(f"{label}: NaN patterns of kernel and plain differ")
    dd = (got[0] - ref[0]).abs().nan_to_num()
    bad = dd > d_tol
    dj = torch.zeros_like(dd)
    for g, r in zip(got[1:], ref[1:]):
        dj = torch.maximum(dj, (g - r).abs().nan_to_num().amax(-1))
    bad |= dj > j_tol
    n, n_bad = dd.numel(), int(bad.sum())
    print(f"{label}: {n} queries, {n_bad} with |dd| > {d_tol:.0e} or |dJ| "
          f"> {j_tol:.0e} ({100 * n_bad / n:.4f} %); max |dd| "
          f"{float(dd.max()):.3e}, max |dJ| {float(dj.max()):.3e}; among "
          f"the queries within tolerance max |dd| "
          f"{float(dd[~bad].max()):.3e}, |dJ| {float(dj[~bad].max()):.3e}")
    allowed = 0 if f64 else int(PRIM_FRAC * n)
    if n_bad > allowed:
        raise SystemExit(f"{label}: kernel and plain differ on {n_bad} "
                         f"queries (allowed {allowed})")
    return max(float(dd.max()), float(dj.max()))


def primitive_bound(plan, fks, prm, outs) -> tuple[int, int]:
    """(operations, bytes) of one kernel call: ``primitive_flops`` of each
    kernel group's queries, ``primitive_bytes``."""
    n_batch = int(np.prod(fks[0][0].shape[:-3]))
    jac = len(outs) > 1
    flops = sum(n_batch * n * fp.primitive_flops(mode, key, jac, plan.n_dof)
                for mode, key, n, _ in plan.kernel_groups)
    return flops, fp.primitive_bytes(plan, fks, outs, prm)


def phase_primitive_kernel_check(dev) -> dict:
    """The primitive narrowphase kernel on the flagship's first
    convexification and evaluation at B = 256: every call held against the
    plain version (float32, and the largest call in float64), the largest
    call (the swept Jacobians) timed beside the plain version, with its
    bound."""
    calls = primitive_main_inputs(dev)
    errs = []
    for i, call in enumerate(calls):
        scene, kind, fks, prm, n_out = call
        errs.append(hold_primitive(
            f"primitive call {i} ({kind}, {'Jacobians' if n_out > 1 else 'values'}, "
            f"batch {tuple(fks[0][0].shape[:-3])}, {n_out} outputs)", call))
    main = max(calls, key=lambda c: c[4])
    hold_primitive("primitive, largest call, float64", main, torch.float64)
    plan, fks, got, _ = primitive_outputs(main)
    scene, kind, _, prm, _ = main
    ms = cuda_ms(lambda: fp.query_cuda(plan, fks, prm, got), 10)
    plain_ms = cuda_ms(lambda: fp.query_plain(scene, plan, fks, prm, got), 2)
    flops, nbytes = primitive_bound(plan, fks, prm, got)
    bound_ms, bound_by, t_ops, t_bytes = bound(flops, nbytes)
    n = got[0].numel()
    print(f"primitive kernel on the largest call ({kind} Jacobians, {n} "
          f"queries in {len(plan.kernel_groups)} groups, one launch each): "
          f"kernel {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms, "
          f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms); roofline share "
          f"{bound_ms / ms:.2%}")
    return {"name": "primitive_narrowphase", "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/primitive_narrowphase.cu",
            "replaces": "trajopt_tpu/collision/world.py:969",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the narrowphase
            "library_ms": None}


def small_qp_step(dev) -> torch.Tensor:
    """The first QP of pr2ish (10 steps, 3 lanes) on ``dev``, run for all
    450 ADMM iterations (eps 0).  Returns the QP solutions [3, 80]."""
    prep, lb, ub, x = first_qp(10, 3, 5, dev)
    cfg = dataclasses.replace(flagship_params().qp, eps_abs=0.0, eps_rel=0.0)
    return solve_qp_block_prepared(prep, lb, ub, x, cfg=cfg).x


def small_solve(path: str, dev, perturb: int | None = None,
                dtype=torch.float32):
    """A whole 10-step solve on 3 lanes in ``dtype`` on ``dev`` -- the inputs
    of the CPU tests that hold the port's float32 solves against the JAX
    package's: ``"pr2ish"`` (flagship settings, LVS 2, block path),
    ``"hard"`` and ``"hard rescale"`` (the same on borderline goals, the
    latter with ``rescale_duals_on_escalation``), ``"arm7"`` and ``"arm7
    ipm"`` (discrete settings, dense path, ADMM or IPM).  ``perturb``
    seeds a uniform +-1e-6 perturbation of the inits' free steps.  Returns
    (status, SQP iterations, QP solves, x, largest merit coefficient) on
    the CPU."""
    if path.startswith("arm7"):
        # Seed 1: its float32 decisions clear their thresholds, so two
        # float32 implementations take the same path (the CPU gives the
        # same counts at any thread count and under 3e-6 perturbations of
        # the inits, and they equal float64's).  With seed 0 a trust-region
        # test lands within rounding of min_approx_improve and the CPU's
        # own counts change with its thread count (PERF.md).  On the IPM
        # no seed of 0-299 keeps the CPU's counts under perturbations (the
        # float32 IPM stops at a complementarity gap of ~1e-4); seed 1
        # takes the same path on the card as on the CPU (of seeds 0-23,
        # 1, 4 and 12 do; PERF.md).
        prob, _ = arm_table_problem(n_steps=10, device=dev)
        params = discrete_params()
        if path == "arm7 ipm":
            params = dataclasses.replace(params, qp_algorithm="ipm")
        solve = make_solver(prob.build(), params)
        inits, goals = arm_table_batch(1, 3, 10, dtype=dtype, device=dev)
    else:
        prob, _ = pr2ish_table_problem(n_steps=10, lvs_substeps=2,
                                       device=dev)
        params = flagship_params()
        if path == "hard rescale":
            params = dataclasses.replace(params,
                                         rescale_duals_on_escalation=True)
        solve = make_solver(prob.build(), params, structured=True)
        hard = path != "pr2ish"
        inits, goals = pr2ish_table_batch(
            HARD_SMALL_SEED if hard else 0, 3, 10, dtype=dtype,
            device=dev, hard_frac=1.0 if hard else 0.0)
    x0 = inits.reshape(3, -1)
    if perturb is not None:
        d = goals.shape[1]
        noise = np.random.default_rng(perturb).uniform(
            -1e-6, 1e-6, (3, x0.shape[1] - d))
        x0 = torch.cat([x0[:, :d], x0[:, d:] + torch.as_tensor(
            noise, dtype=x0.dtype, device=dev)], 1)
    res = solve(x0, *prob.bounds(x0), {"goal": goals})
    return [t.cpu() for t in (res.status, res.n_iter, res.n_qp_solves,
                              res.x, res.merit_coeffs.amax(-1))]


def small_json_solve(path: str, dev, perturb: int | None = None,
                     dtype=torch.float32):
    """A solve of a problem document on ``dev`` (float32 unless ``dtype``
    says otherwise), as :func:`small_solve`: ``"arm_table.json"`` (the port's copy, 10 steps,
    its own init, 1 lane) or ``"reach"`` (:func:`reach_document` at 10
    steps, 3 lanes with straight-line inits to ``arm7_goals(1, 3)``), with
    the document's settings.  Returns (status, SQP iterations, QP solves,
    x, largest merit coefficient) on the CPU."""
    if path == "arm_table.json":
        jp = load_problem_file(str(ARM_TABLE_JSON), arm7_env(), device=dev)
        x0 = jp.init_traj.reshape(1, -1).to(dev, dtype)
    else:
        jp = construct_problem(reach_document(10), arm7_env(), device=dev)
        x0 = arm_table_batch(1, 3, 10, dtype=dtype,
                             device=dev)[0].reshape(3, -1)
    if perturb is not None:
        noise = np.random.default_rng(perturb).uniform(
            -1e-6, 1e-6, (x0.shape[0], x0.shape[1] - 7))
        x0 = torch.cat([x0[:, :7], x0[:, 7:] + torch.as_tensor(
            noise, dtype=x0.dtype, device=dev)], 1)
    res = make_solver(jp.prob.build(), jp.sqp)(x0, *jp.prob.bounds(x0), {})
    return [t.cpu() for t in (res.status, res.n_iter, res.n_qp_solves,
                              res.x, res.merit_coeffs.amax(-1))]


def first_structured_qp(n_steps: int, lanes: int, seed: int, dev):
    """The pr2ish first QP's rows (LVS 2, initial merit coefficients, trust
    box 0.1 around the straight-line inits) as the gather-banded QP the
    solver builds when the rows are not step-aligned.  Returns
    (StructuredQP, x)."""
    prob, _ = pr2ish_table_problem(n_steps=n_steps, lvs_substeps=2,
                                   device=dev)
    nlp = prob.build()
    inits, goals = pr2ish_table_batch(seed, lanes, n_steps, device=dev)
    x = inits.reshape(lanes, -1)
    params = {"goal": goals}
    lb, ub = prob.bounds(x)
    model = nlp_mod.convexify_structured(
        nlp, x, params, nlp_mod.linear_jacobians(nlp, x, params))
    coeffs = x.new_full((lanes, nlp_mod.num_cnt_groups(nlp)),
                        flagship_params().initial_merit_error_coeff)
    qp = banded_qp(nlp, nlp_mod.structured_band(nlp)[0], model, coeffs,
                   torch.maximum(lb, x - 0.1), torch.minimum(ub, x + 0.1))
    return qp, x


def hold_ipm(label: str, got, plain, ref) -> None:
    """The card's float32 IPM result ``got`` against the CPU's float64 IPM
    x ``ref`` on the same float32 inputs, beside the CPU's float32 results
    ``plain`` (the same QP, then :func:`perturbed_qps`' copies).  The
    float32 IPM stops at its own gate (complementarity ~1e-4) or at its
    step limit, and which lanes pass the gate is not determined by float32
    inputs; so, as :func:`hold_in_cpu_range` holds counts and x, the card
    must converge no fewer lanes than the CPU's float32 in its worst run,
    less 1 % of the lanes, and on the lanes that converge on the card and
    in the CPU's float32 solve of the same QP, x may be at most
    CHUNK_NOISE times the CPU's largest float32 distance to float64 on
    those lanes (over ``plain``) away from float64, and never needs to be
    closer than SMALL_XTOL of the magnitude.  The distance over every lane
    is printed beside it."""
    mag = max(1.0, float(ref.abs().max()))
    conv = got.converged.cpu() & plain[0].converged.cpu()
    d_k = (got.x.double().cpu() - ref).abs().amax(-1)
    d_p = torch.stack([(p.x.double().cpu() - ref).abs().amax(-1)
                       for p in plain])
    err_k, err_p = float(d_k[conv].max()), float(d_p[:, conv].max())
    tol = max(CHUNK_NOISE * err_p, SMALL_XTOL * mag)
    n_conv = int(got.converged.sum())
    least = min(int(p.converged.sum()) for p in plain) - \
        math.ceil(0.01 * len(d_k))
    print(f"{label}: against CPU float64 on the {int(conv.sum())} lanes "
          f"converged on the card and the CPU: card float32 max |dx| "
          f"{err_k:.3e} (rel {err_k / mag:.2e}), CPU float32 "
          f"{[f'{float(d[conv].max()):.3e}' for d in d_p]} (the QP, then "
          f"1e-6 changes of A); tolerance {tol:.3e}; over every lane: card "
          f"{float(d_k.max()):.3e}, CPU float32 "
          f"{[f'{float(d.max()):.3e}' for d in d_p]}; card converged "
          f"{n_conv} (at least {least})")
    if n_conv < least:
        raise SystemExit(f"{label}: the card converged {n_conv} lanes")
    if not err_k <= tol:
        raise SystemExit(f"{label}: card and CPU differ by {err_k:.3e}")


def hold_x(label: str, got, ref) -> None:
    """Card float32 x against CPU float64 x, within SMALL_XTOL of the
    solution's magnitude."""
    dx = float((got.double().cpu() - ref).abs().max())
    tol = SMALL_XTOL * max(1.0, float(ref.abs().max()))
    print(f"{label}: card float32 vs CPU float64 max |dx| {dx:.3e}, "
          f"tolerance {tol:.3e}")
    if not dx <= tol:
        raise SystemExit(f"{label}: card and CPU differ by {dx:.3e}")


def phase_small_reference():
    """The card's paths (float32, kernels) against the CPU's plain
    versions, which the CPU tests hold against the JAX package: one pr2ish
    QP step against float64, and a whole solve of each path against
    float32."""
    profiling.reset()
    gpu = small_qp_step(torch.device("cuda")).double().cpu()
    if _count(BLOCK_LAUNCHES) == 0:
        raise SystemExit("the card's QP step did not launch the kernel")
    cpu = small_qp_step(torch.device("cpu"))
    dx = float((gpu - cpu).abs().max())
    tol = SMALL_XTOL * max(1.0, float(cpu.abs().max()))
    print(f"small QP step (pr2ish 10 steps, 3 lanes, 450 iterations): card "
          f"float32 vs CPU float64 max |dx| {dx:.3e}, tolerance {tol:.3e}")
    if not dx <= tol:
        raise SystemExit(f"card and CPU QP solutions differ by {dx:.3e}")

    # The IPM on the arm7 path's first QP (B 128, n 210, m 449), and the
    # gather-banded ADMM on the pr2ish 10-step first QP's rows (all 450
    # iterations, eps 0), card float32 against CPU float64 on the same
    # float32 inputs (the QP as the card builds it, through the primitive
    # kernel).
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    eps = discrete_params().qp.eps_abs
    profiling.reset()
    qp, x0 = arm7_first_qp(ARM_STEPS, ARM_B, 0, cuda)
    if _count(PRIMITIVE_LAUNCHES) == 0:
        raise SystemExit("the arm7 first QP was built without the "
                         "primitive kernel")
    t0 = time.time()
    got = solve_qp_ipm(qp, x0, cfg=ipm_config(torch.float32, eps))
    torch.cuda.synchronize()
    t_card = time.time() - t0
    qp_cpu = dense.QPData(*(t.cpu() for t in qp))
    ref = solve_qp_ipm(dense.QPData(*(t.double() for t in qp_cpu)),
                       x0.double().cpu(), cfg=ipm_config(torch.float64, eps))
    plain = [solve_qp_ipm(q, x0.cpu(), cfg=ipm_config(torch.float32, eps))
             for q in perturbed_qps(qp_cpu, 2)]
    print(f"IPM on the arm7 path's first QP (B {ARM_B}, n {qp.A.shape[2]}, "
          f"m {qp.A.shape[1]}): card {t_card:.2f} s, converged "
          f"{int(got.converged.sum())}/{ARM_B} (CPU float32 "
          f"{[int(r.converged.sum()) for r in plain]}, float64 "
          f"{int(ref.converged.sum())}), Newton steps card "
          f"{int(got.iters.min())}-{int(got.iters.max())}, CPU float64 "
          f"{int(ref.iters.min())}-{int(ref.iters.max())}")
    hold_ipm("IPM arm7 first QP", got, plain, ref.x)
    cfg = dataclasses.replace(flagship_params().qp, eps_abs=0.0, eps_rel=0.0)
    sqp_, x0 = first_structured_qp(10, 3, 5, cuda)
    got = solve_qp_structured(sqp_, x0, cfg=cfg)
    sqp_, x0 = first_structured_qp(10, 3, 5, cpu)
    ref = solve_qp_structured(sqp_, x0, cfg=cfg)
    hold_x(f"gather-banded ADMM on the pr2ish first QP's rows (10 steps, "
           f"3 lanes, m {sqp_.C.m}, {cfg.max_iter} iterations)", got.x,
           ref.x)

    hold_json_references()

    # Whole float32 solves, card (kernels, the primitive narrowphase
    # included) against CPU (plain versions), held as
    # :func:`hold_in_cpu_range` says over SMALL_PERTURBATIONS changes of
    # the inits: the hard solve's lane 0 takes 4 or 5 SQP iterations on
    # the CPU itself under such changes.
    for path, counter in (("pr2ish", BLOCK_LAUNCHES),
                          ("hard", BLOCK_LAUNCHES),
                          ("hard rescale", BLOCK_LAUNCHES),
                          ("arm7", DENSE_LAUNCHES), ("arm7 ipm", None)):
        profiling.reset()
        gpu = small_solve(path, cuda)
        if counter is not None and _count(counter) == 0:
            raise SystemExit(f"small {path} solve did not launch its kernel")
        if _count(PRIMITIVE_LAUNCHES) == 0:
            raise SystemExit(f"small {path} solve did not launch the "
                             f"primitive kernel")
        runs = [small_solve(path, cpu)] + [
            small_solve(path, cpu, perturb=k)
            for k in range(SMALL_PERTURBATIONS)]
        if path.startswith("hard") and not float(runs[0][4].max()) > \
                flagship_params().initial_merit_error_coeff:
            raise SystemExit(f"small {path} solve did not escalate")
        hold_in_cpu_range(f"small solve ({path} 10 steps, 3 lanes)", gpu,
                          runs, f"; largest merit coefficient per lane "
                          f"{runs[0][4].tolist()}")


def perturbed_qps(qp, n: int):
    """``qp`` and ``n`` copies whose nonzero constraint entries move by a
    seeded uniform +-1e-6 (the size of the primitive kernel's differences
    from the plain version's Jacobians, <= 5.7e-6 on the arm7 first QP)."""
    out = [qp]
    for k in range(n):
        g = torch.Generator().manual_seed(k)
        noise = torch.rand(qp.A.shape, generator=g, dtype=qp.A.dtype) * 2 - 1
        out.append(qp._replace(A=qp.A + (qp.A != 0) * noise * 1e-6))
    return out


def hold_in_cpu_range(label: str, gpu, runs, note: str = "") -> None:
    """A float32 solve on the card (kernels) against the CPU's (plain
    versions): ``runs`` are the CPU's solve of the same inputs, then of
    1e-6 changes of the inits, each (status, SQP iterations, QP solves, x,
    ...).  Float32 decisions near their thresholds (a trust-region test,
    an escalation, a QP that stops short of eps) are not determined by the
    inputs, so the card must converge the same lanes as the CPU with
    counts inside the range the CPU takes over ``runs``, and, where it
    took the CPU's path (equal counts), x within CHUNK_NOISE times the
    CPU's own spread (at least SOLVE_XTOL)."""
    names = ("status", "SQP iterations", "QP solves")
    cpu_res = runs[0]
    spread = torch.stack([(r[3] - cpu_res[3]).abs().amax(-1)
                          for r in runs[1:]]).amax(0)
    tol = torch.clamp_min(CHUNK_NOISE * spread, SOLVE_XTOL)
    dx = (gpu[3] - cpu_res[3]).abs().amax(-1)
    lo = [torch.stack([r[k] for r in runs]).amin(0) for k in (1, 2)]
    hi = [torch.stack([r[k] for r in runs]).amax(0) for k in (1, 2)]
    print(f"{label} (float32): card vs CPU " + ", ".join(
        f"{n} {g.tolist()} vs {c.tolist()}"
        for n, g, c in zip(names, gpu, cpu_res))
        + f"; CPU under 1e-6 changes: SQP iterations "
        f"{[r[1].tolist() for r in runs[1:]]}, QP solves "
        f"{[r[2].tolist() for r in runs[1:]]}; max |dx| per lane "
        f"{[f'{v:.3e}' for v in dx.tolist()]}, tolerance "
        f"{[f'{v:.1e}' for v in tol.tolist()]}{note}")
    if not torch.equal(gpu[0], cpu_res[0]):
        raise SystemExit(f"{label} float32: statuses differ")
    for k, n in ((1, "SQP iterations"), (2, "QP solves")):
        if not bool(((gpu[k] >= lo[k - 1]) & (gpu[k] <= hi[k - 1])).all()):
            raise SystemExit(f"{label} float32: card {n} outside the CPU's "
                             f"range")
    same = (gpu[1] == cpu_res[1]) & (gpu[2] == cpu_res[2])
    if not bool((dx[same] <= tol[same]).all()):
        raise SystemExit(f"{label} float32: card and CPU x differ by "
                         f"{dx.tolist()}")


@contextlib.contextmanager
def plain_dense_chunk():
    """Within the block, ``fused_dense.chunk`` runs its plain version on
    any device (and counts no launch): the float64 references on the card,
    which the kernel (float32 only) cannot run."""
    def plain(*args, active=None, **kw):
        out = fd.chunk_plain(*args, **kw)
        if active is None:
            return out
        keep = active[:, None]
        return (*(torch.where(keep, new, old)
                  for new, old in zip(out[:3], args[7:])),
                torch.where(keep, out[3], torch.nan))

    saved, fd.chunk = fd.chunk, plain
    try:
        yield
    finally:
        fd.chunk = saved


def hold_json_references():
    """The JSON front end's small references, card against CPU: the port's
    arm_table.json (10 steps, 1 lane) and the reach document at 10 steps
    on 3 lanes, each with the document's settings.

    In float64 (the dense chunk's plain version on the card) the card
    repeats the CPU's solve: equal status and counts, x within 1e-6.  In
    float32 the document's QP settings (eps 1e-8, which float32 never
    reaches, so every QP runs its 1500 iterations) do not determine the
    counts: under 1e-6 changes of the inits the CPU's own float32 solves
    of arm_table.json take 6/9, 3/3 and 5/5 SQP iterations / QP solves,
    and the JAX package's float32 solves of it 5/5, 5/6, 3/3 and 6/9.  So
    the card (kernel) must converge the same lanes as the CPU (plain
    version) with counts inside the range the CPU takes over three such
    changes, and x within 4x the CPU's own spread (at least SOLVE_XTOL)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for path in ("arm_table.json", "reach"):
        with plain_dense_chunk():
            g64 = small_json_solve(path, cuda, dtype=torch.float64)
        c64 = small_json_solve(path, cpu, dtype=torch.float64)
        dx64 = float((g64[3] - c64[3]).abs().max())
        names = ("status", "SQP iterations", "QP solves")
        print(f"small {path} (float64, plain chunk on the card): card vs "
              f"CPU " + ", ".join(f"{n} {g.tolist()} vs {c.tolist()}"
                                  for n, g, c in zip(names, g64, c64))
              + f"; max |dx| {dx64:.3e}, tolerance 1e-6")
        if not (all(torch.equal(g, c) for g, c in zip(g64[:3], c64[:3]))
                and dx64 <= 1e-6):
            raise SystemExit(f"small {path} float64: card and CPU differ")

        profiling.reset()
        gpu = small_json_solve(path, cuda)
        if _count(DENSE_LAUNCHES) == 0:
            raise SystemExit(f"small {path} solve did not launch the "
                             f"dense kernel")
        runs = [small_json_solve(path, cpu)] + [
            small_json_solve(path, cpu, perturb=k) for k in range(3)]
        hold_in_cpu_range(f"small {path}", gpu, runs,
                          f"; {_count(DENSE_LAUNCHES)} dense kernel launches")


# The solver's profiler ranges (torch.profiler.record_function), one per
# layer: convexification, QP preparation (Ruiz, dual-cost scale and the
# factorization; per SQP step on the block path, per QP inside "sqp.qp"
# on the dense path), the QP solves, and the model and exact evaluations
# of the trust-region test.
LAYERS = ("sqp.init", "sqp.convexify", "qp.prepare", "sqp.qp",
          "sqp.evaluate", "collision.convex", "collision.primitive")


class Trace:
    """A profile's raw events, read once and without building torch's
    event tree (which takes tens of seconds on a solve's trace): the
    device spans (kernels and copies; the ranges' own device annotations
    left out), the solver's ranges on the host, and for each device span
    the host start of the op that launched it (its linked correlation).

    The kernels of a CUDA graph replay are traced one by one, but their
    linked correlation names no host op; their own correlation id is
    their ``cudaGraphLaunch`` call's, whose host start stands for their
    launch (``graph_spans`` counts them).  A hand kernel launched through
    ctypes has no linked op either: its own correlation id is its
    ``cudaLaunchKernel`` call's, whose host start stands for its launch."""

    def __init__(self, prof):
        cuda = torch.autograd.DeviceType.CUDA
        self.ranges = {name: [] for name in LAYERS}
        self.spans = []                 # (name, start, end, linked id)
        starts = {}                     # correlation id -> host start
        own = []                        # each span's own correlation id
        graph_at = {}                   # cudaGraphLaunch id -> host start
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if not name.startswith(("sqp.", "qp.", "collision.")):
                    self.spans.append((name, e.start_ns(), e.end_ns(),
                                       e.linked_correlation_id()))
                    own.append(e.correlation_id())
                continue
            if name in self.ranges:
                self.ranges[name].append((e.start_ns(), e.end_ns()))
            if name.startswith("cudaGraphLaunch"):
                graph_at[e.correlation_id()] = e.start_ns()
            if e.correlation_id():
                starts.setdefault(e.correlation_id(), e.start_ns())
        self.launch = [starts.get(c) if c in starts else starts.get(o)
                       for (_, _, _, c), o in zip(self.spans, own)]
        self.replays_traced = len(graph_at)
        self.graph_spans = 0
        for k, c in enumerate(own):
            if c in graph_at:
                self.launch[k] = graph_at[c]
                self.graph_spans += 1

    def inside(self, name: str) -> list[int]:
        """Indices of the device spans launched inside range ``name``."""
        rs = sorted(self.ranges[name])
        begins = [a for a, _ in rs]
        out = []
        for k, t in enumerate(self.launch):
            i = bisect.bisect_right(begins, t) - 1 if t is not None else -1
            if i >= 0 and t <= rs[i][1]:
                out.append(k)
        return out

    def layer_split(self) -> str:
        """Host time (inclusive) of each of the solver's ranges and device
        time and count of the spans launched inside it, summed over its
        calls (ranges the run never entered left out)."""
        out = []
        for name, rs in self.ranges.items():
            if not rs:
                continue
            ks = self.inside(name)
            dev = sum(self.spans[k][2] - self.spans[k][1] for k in ks)
            host = sum(b - a for a, b in rs)
            out.append(f"{name} host {host / 1e6:.1f} ms, device "
                       f"{dev / 1e6:.1f} ms, {len(ks)} device spans "
                       f"({len(rs)} calls)")
        return "; ".join(out)

    def busy_share(self, wall_s: float) -> float | None:
        """Share of the wall time during which a device span ran (their
        union), or None when the trace has none."""
        spans = sorted((s, e) for _, s, e, _ in self.spans)
        if not spans:
            return None
        busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        return busy / (wall_s * 1e9)

    def kernel_time(self, kernel: str) -> tuple[int, float]:
        """(launches, device ms) of the spans whose name holds
        ``kernel``."""
        spans = [e - s for name, s, e, _ in self.spans if kernel in name]
        return len(spans), sum(spans) / 1e6

    def kernel_runs(self, kernel: str) -> int:
        """Runs of consecutive device spans (in start order) whose name
        holds ``kernel``: the calls of a wrapper that launches its kernel
        once a group, back to back on one stream."""
        runs, prev = 0, False
        for name, _, _, _ in sorted(self.spans, key=lambda sp: sp[1]):
            hit = kernel in name
            runs += hit and not prev
            prev = hit
        return runs

    def top(self, k: int = 10, among=None) -> str:
        """The ``k`` device spans with the most time, summed by name (of
        the spans indexed by ``among``, default all)."""
        tot = {}
        for j in range(len(self.spans)) if among is None else among:
            name, s, e, _ = self.spans[j]
            n, t = tot.get(name, (0, 0))
            tot[name] = (n + 1, t + e - s)
        rows = sorted(tot.items(), key=lambda kv: -kv[1][1])[:k]
        return "; ".join(f"{name[:60]} {t / 1e6:.2f} ms ({n})"
                         for name, (n, t) in rows)


def _count(name: str):
    """The registry's counter ``name`` (0 before its first count)."""
    return profiling.counters().get(name, 0)


def print_outcome(label: str, res, verified, n_hard: int) -> None:
    """Status and SQP-iteration histograms (bench.py's edges), the largest
    merit coefficient, and the counts of the first ``n_hard`` lanes."""
    it = res.n_iter.cpu().numpy()
    hist = np.histogram(it, bins=ITER_EDGES)[0]
    status = torch.bincount(res.status.cpu().long(), minlength=6).tolist()
    print(f"{label}: statuses " + ", ".join(
        f"{SQPStatus.NAMES[k]} {v}" for k, v in enumerate(status) if v)
          + "; SQP iterations histogram " + " ".join(
              f"[{a},{b}):{h}" for a, b, h in zip(ITER_EDGES[:-1],
                                                  ITER_EDGES[1:], hist))
          + f" max={int(it.max())}; largest merit coefficient "
          f"{float(res.merit_coeffs.max()):.3g}")
    if n_hard:
        conv = res.status[:n_hard] == SQPStatus.CONVERGED
        print(f"{label}: hard lanes (first {n_hard}): converged "
              f"{int(conv.sum())}/{n_hard}, converged and swept-verified "
              f"{int(verified[:n_hard].sum())}/{n_hard}, mean SQP "
              f"iterations {float(res.n_iter[:n_hard].float().mean()):.2f}"
              f"; other lanes {float(res.n_iter[n_hard:].float().mean()):.2f}")


def drive_path(label: str, solve, scene, batch, B: int, n_steps: int,
               n_dof: int, counter, kernel: str, smi: str,
               min_verified: int | None, profile: bool = True,
               n_hard: int = 0, after=None,
               traced: dict | None = None) -> int:
    """A warm-up solve of the measured batch (so that it meets every lane
    bucket the measured solve captures; the captures it makes are
    printed), then the measured solve of ``B`` seeded lanes with the
    kernel's launch count and ``aot_cache.STATS`` set to 0 just before
    and read just after;
    the independent swept check of every lane; with ``profile`` a
    profiled repeat for the device's idle share, the layer split, its top
    kernels and the in-path time of the chunk kernel ``kernel``.  With ``n_hard`` the
    status and iteration histograms and the first ``n_hard`` lanes'
    counts; with ``after`` a call ``after(res, stats)`` on
    the measured solve's result and its (captures, capture seconds,
    replays) before the repeats; with ``traced`` a dict that takes the
    profiled repeat's narrowphase kernel launches (:func:`profile_solve`).
    Fails below ``min_verified`` converged and swept-verified lanes or
    when the kernel never launched.  Returns the launch count."""
    inits, goals = batch(1, B, n_steps)
    aot_cache.STATS.reset()
    t0 = time.time()
    solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    print(f"{label}: warm-up solve {time.time() - t0:.2f} s "
          f"({aot_cache.STATS})")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    t0 = time.time()
    res = solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _count(counter)
    stats = (aot_cache.STATS.captures, aot_cache.STATS.capture_s,
             aot_cache.STATS.replays)

    if tuple(res.x.shape) != (B, n_steps * n_dof) or \
            not bool(torch.isfinite(res.x).all()):
        raise SystemExit(f"{label}: trajectories not finite or of the "
                         f"wrong shape")
    traj = res.x.reshape(B, n_steps, n_dof)
    mins = swept_verify(scene, traj)
    conv = res.status == SQPStatus.CONVERGED
    verified = conv & (mins > 0)
    n_conv, n_ver = int(conv.sum()), int(verified.sum())
    goal_err = (float((traj[conv, -1] - goals[conv]).abs().max())
                if n_conv else float("nan"))
    print(f"{label}: converged {n_conv}/{B}, converged and swept-verified "
          f"{n_ver}/{B}, worst clearance {float(mins.min()):+.4f}, max goal "
          f"error {goal_err:.2e}, mean SQP iterations "
          f"{float(res.n_iter.float().mean()):.2f}, mean QP solves "
          f"{float(res.n_qp_solves.float().mean()):.2f}, statuses "
          f"{torch.bincount(res.status.cpu().long(), minlength=5).tolist()}")
    print(f"{label}: {wall:.3f} s for {B} lanes -> {n_ver / wall:.2f} "
          f"verified solves/s on {smi}; kernel launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB ({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved); "
          f"captures {stats[0]} ({stats[1]:.3f} s), replays {stats[2]}")
    if n_hard:
        print_outcome(label, res, verified, n_hard)
    if launches <= 0:
        raise SystemExit(f"{label}: the solve never launched its kernel")
    if min_verified is not None and n_ver < min_verified:
        raise SystemExit(f"{label}: only {n_ver}/{B} lanes converged and "
                         f"verified (< {min_verified})")
    if after is not None:
        after(res, stats)
    if profile:
        got = profile_solve(label, lambda: solve(inits, {"goal": goals}),
                            kernel, launches)
        if traced is not None:
            traced.update(got)
    return launches


def profile_solve(label: str, run, kernel: str, launches: int) -> dict:
    """A profiled repeat of ``run()`` (one solve): the device's idle share,
    the layer split, the top kernels and the in-path time of the chunk
    kernel ``kernel`` beside its ``launches`` counted in the measured
    solve, and the narrowphase kernels' traced launches and the
    narrowphase ranges' device time.  Returns {kernel name: (traced
    launches, device ms)} of the two narrowphase kernels (empty when no
    device events were traced)."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    replays = aot_cache.STATS.replays
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        pwall = time.time() - t0
    replays = aot_cache.STATS.replays - replays
    t0 = time.time()
    trace = Trace(prof)
    share = trace.busy_share(pwall)
    print(f"{label}: the profiled solve replayed {replays} captured "
          f"regions ({trace.replays_traced} cudaGraphLaunch calls traced); "
          f"{trace.graph_spans} of {len(trace.spans)} traced device spans "
          f"launched by them")
    if replays and not trace.graph_spans:
        print(f"{label}: the replayed kernels could not be attributed to "
              f"their launches: the layer split below leaves the regions "
              f"out (the idle share counts every traced span)")
    traced = {}
    if share is None:
        print(f"{label}: device idle share not measured (no device events "
              f"traced)")
    else:
        print(f"{label}: profiled solve {pwall:.3f} s wall, device busy "
              f"{share:.4f}, idle share {1 - share:.4f} (under the "
              f"profiler)")
        print(f"{label}: by layer: {trace.layer_split()}")
        n_k, ms_k = trace.kernel_time(kernel)
        print(f"{label}: {kernel} in the path: {launches} launches "
              f"counted, {n_k} traced, {ms_k:.3f} ms device time "
              f"({ms_k / max(n_k, 1):.4f} ms each)")
        for name in (fc.KERNEL, fp.KERNEL):
            n_c, ms_c = traced[name] = trace.kernel_time(name)
            calls = (f" in {trace.kernel_runs(name)} query calls (runs of "
                     f"back-to-back launches)" if name == fp.KERNEL else "")
            if n_c:
                print(f"{label}: {name}: {n_c} launches traced in the "
                      f"solve{calls}, {ms_c:.3f} ms device time "
                      f"({ms_c / n_c:.4f} ms each)")
        print(f"{label}: top device time by kernel: {trace.top()}")
        total = sum(e - s for _, s, e, _ in trace.spans)
        for what, rng, name in (("convex", "collision.convex", fc.KERNEL),
                                ("primitive", "collision.primitive",
                                 fp.KERNEL)):
            if not trace.ranges[rng]:
                continue
            ks = trace.inside(rng)
            dev = sum(trace.spans[k][2] - trace.spans[k][1] for k in ks)
            print(f"{label}: {what} narrowphase ({rng}): "
                  f"{dev / 1e6:.1f} ms of {total / 1e6:.1f} ms device time "
                  f"({100 * dev / max(total, 1):.2f} %), {len(ks)} "
                  f"device spans in {len(trace.ranges[rng])} "
                  f"calls; its top: {trace.top(among=ks)}")
            if what == "convex" and traced[name][0] == 0:
                raise SystemExit(f"{label}: the profiled solve ran the "
                                 f"convex narrowphase without its kernel")
            sorts = {trace.spans[k][0] for k in ks
                     if "sort" in trace.spans[k][0].lower()}
            if what == "convex" and sorts:
                raise SystemExit(f"{label}: sort kernels in {rng}: "
                                 f"{sorted(sorts)}")
    print(f"{label}: reading the profile took {time.time() - t0:.1f} s")
    return traced


def perturbed(inits: torch.Tensor, seed: int) -> torch.Tensor:
    """``inits [B, T, D]`` with every step after the first moved by a
    seeded uniform +-1e-6."""
    noise = np.random.default_rng(seed).uniform(
        -1e-6, 1e-6, (inits.shape[0], inits.shape[1] - 1, inits.shape[2]))
    return torch.cat([inits[:, :1], inits[:, 1:] + torch.as_tensor(
        noise, dtype=inits.dtype, device=inits.device)], 1)


@contextlib.contextmanager
def plain_primitive():
    """Within the block every primitive narrowphase query runs the plain
    version on any device (and counts no launch)."""
    saved = fp.query

    def plain(scene, kind, fks, params, outs):
        if outs[0].device.type == "meta":
            return outs
        return fp.query_plain(scene, fp.plan_of(scene, kind, fks[0][0]),
                              fks, params, outs)

    fp.query = plain
    try:
        yield
    finally:
        fp.query = saved


def phase_flagship(smi: str) -> tuple[int, int, int]:
    """The flagship (see the module doc, phase 6).  The primitive kernel
    runs inside the captured regions (init, convexify, evaluate), where
    its wrapper is called while a region is warmed up and captured, not
    when it is replayed: its launches are counted over the path's first
    solve (which makes the captures) and traced by name in the profiled
    repeats.  Returns (block kernel launches of the measured solve,
    primitive kernel launches and query calls of the first solve)."""
    prob, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2)
    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(1, B, 30)
    torch.cuda.synchronize()
    profiling.reset()
    t0 = time.time()
    solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    prim, calls = _count(PRIMITIVE_KERNELS), _count(PRIMITIVE_LAUNCHES)
    print(f"flagship: first solve {time.time() - t0:.2f} s "
          f"({aot_cache.STATS}); {fp.KERNEL} launched {prim} times by "
          f"{calls} query calls")
    if prim <= 0:
        raise SystemExit("flagship: the primitive narrowphase kernel never "
                         "launched")

    def against_plain(res, stats):
        keep("flagship", scene, res, 30, 8, MIN_VERIFIED)
        traj = res.x.reshape(B, 30, 8)
        conv = res.status == SQPStatus.CONVERGED
        mins = swept_verify(scene, traj)
        with plain_primitive():
            mins_p = swept_verify(scene, traj)
        n_k = int((conv & (mins > 0)).sum())
        n_p = int((conv & (mins_p > 0)).sum())
        print(f"flagship: converged and swept-verified by the plain "
              f"narrowphase {n_p}/{B} (by the kernel {n_k}/{B}); max "
              f"|clearance difference| {float((mins - mins_p).abs().max()):.3e}")
        if n_p != n_k:
            raise SystemExit("flagship: the plain narrowphase verifies "
                             "another count of lanes than the kernel")
        with plain_primitive(), aot_cache.eager():
            t1 = time.time()
            plain_res = solve(inits, {"goal": goals})
            torch.cuda.synchronize()
            t_plain = time.time() - t1
            moved = [solve(perturbed(inits, k), {"goal": goals})
                     for k in range(2)]
        # Converged lanes' x within 1e-3 is held in float64 below; in
        # float32 it does not hold: QPs that stop at the float32 ADMM's
        # loose tolerance move x by more than 1e-3 on most lanes under
        # 1e-6 changes of the inits, on either route.  So float32 holds
        # the statuses (equal on >= 99 % of the lanes) and that the routes
        # differ by that noise, not by a systematic error: the median
        # |dx| of the lanes converged on both with equal counts within
        # CHUNK_NOISE times the plain route's own median move under two
        # such changes.  The lanes beyond 1e-3, and beyond CHUNK_NOISE
        # times their own move, are printed.
        both = (res.status == SQPStatus.CONVERGED) & \
            (plain_res.status == SQPStatus.CONVERGED)
        same = both & (res.n_iter == plain_res.n_iter) & \
            (res.n_qp_solves == plain_res.n_qp_solves)
        dx = (res.x - plain_res.x).abs().amax(-1)
        spread = torch.stack([(m.x - plain_res.x).abs().amax(-1)
                              for m in moved]).amax(0)
        beyond = dx[same] > torch.clamp_min(CHUNK_NOISE * spread[same],
                                            CAPTURE_XTOL)
        med_k, med_p = float(dx[same].median()), float(spread[same].median())
        n_status = int((res.status != plain_res.status).sum())
        print(f"flagship: the same batch with the plain narrowphase (eager) "
              f"{t_plain:.2f} s: statuses differ on {n_status}/{B} lanes "
              f"(limit {CAPTURE_STATUS_FRAC:.0%}); SQP iterations differ on "
              f"{int((res.n_iter != plain_res.n_iter).sum())} lanes; "
              f"converged lanes' |dx| max {float(dx[both].max()):.3e}, "
              f"median {float(dx[both].median()):.3e}, > {CAPTURE_XTOL:.0e} "
              f"on {int((dx[both] > CAPTURE_XTOL).sum())}/{int(both.sum())} "
              f"lanes (float32); the plain route's own |dx| under 1e-6 "
              f"changes of the inits: max {float(spread[both].max()):.3e}, "
              f"median {float(spread[both].median()):.3e}, > "
              f"{CAPTURE_XTOL:.0e} on "
              f"{int((spread[both] > CAPTURE_XTOL).sum())} lanes; on the "
              f"{int(same.sum())} lanes with equal counts: median |dx| "
              f"{med_k:.3e} against the own move's {med_p:.3e} (limit "
              f"{CHUNK_NOISE:g}x), beyond max(1e-3, {CHUNK_NOISE:g}x the "
              f"own move) on {int(beyond.sum())} lanes, their |dx| "
              f"{[f'{v:.3e}' for v in dx[same][beyond].tolist()]}")
        if n_status > CAPTURE_STATUS_FRAC * B:
            raise SystemExit(f"flagship: kernel and plain narrowphase "
                             f"statuses differ on {n_status}/{B} lanes")
        if not med_k <= CHUNK_NOISE * med_p:
            raise SystemExit("flagship: kernel and plain narrowphase x "
                             "differ beyond the plain route's own move")
        solver64 = make_solver(prob.build(), flagship_params(),
                               structured=True)
        x64, g64 = pr2ish_table_batch(1, B, 30, dtype=torch.float64)
        x64 = x64.reshape(B, -1)
        bounds = prob.bounds(x64)
        with plain_chunks(), aot_cache.eager():
            t1 = time.time()
            kern64 = solver64(x64, *bounds, {"goal": g64})
            with plain_primitive():
                plain64 = solver64(x64, *bounds, {"goal": g64})
            torch.cuda.synchronize()
        if kern64.x.dtype != torch.float64:
            raise SystemExit("flagship float64: the solve did not run in "
                             "float64")
        print(f"flagship float64 (plain chunks, eager): both routes in "
              f"{time.time() - t1:.2f} s")
        compare_runs("flagship float64", plain64, kern64, B, True,
                     names=("plain narrowphase", "kernel"))

    traced = {}
    block = drive_path("flagship", solve, scene, pr2ish_table_batch, B, 30,
                       8, BLOCK_LAUNCHES, "admm_block_chunk_kernel", smi,
                       MIN_VERIFIED, after=against_plain, traced=traced)
    if traced and traced[fp.KERNEL][0] <= 0:
        raise SystemExit("flagship: no primitive kernel launch traced in "
                         "the captured solve")
    # A replay records no host range inside its graph, so the narrowphase's
    # share of device time is read from an eager profile (the same device
    # work as the captured solve's).
    with aot_cache.eager():
        traced = profile_solve("flagship eager",
                               lambda: solve(inits, {"goal": goals}),
                               "admm_block_chunk_kernel", block)
    if traced and traced[fp.KERNEL][0] <= 0:
        raise SystemExit("flagship: no primitive kernel launch traced in "
                         "the eager solve")
    return block, prim, calls


def phase_arm7(smi: str) -> tuple[int, int, int]:
    """The arm7 discrete workload on the dense path (the default entry
    point, ``make_solve`` with ``structured=False``), with the primitive
    kernel's launches by its discrete entries over the path's first solve
    (which makes the captures; required), then on the block path
    (``bench.py``'s ``discrete_arm7`` line), counts and rate only.  Returns
    (dense kernel launches of the measured solve, primitive kernel
    launches and query calls of the first solve)."""
    prob, scene = arm_table_problem(n_steps=ARM_STEPS)
    solve = prob.make_solve(discrete_params())
    inits, goals = arm_table_batch(1, ARM_B, ARM_STEPS)
    torch.cuda.synchronize()
    profiling.reset()
    t0 = time.time()
    solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    prim, calls = _count(PRIMITIVE_KERNELS), _count(PRIMITIVE_LAUNCHES)
    print(f"arm7 dense: first solve {time.time() - t0:.2f} s "
          f"({aot_cache.STATS}); {fp.KERNEL} launched {prim} times by "
          f"{calls} query calls of the discrete entries")
    if prim <= 0:
        raise SystemExit("arm7 dense: the discrete entries never launched "
                         "the primitive kernel")
    launches = drive_path("arm7 dense", solve, scene, arm_table_batch, ARM_B,
                          ARM_STEPS, 7, DENSE_LAUNCHES, "admm_dense_", smi,
                          ARM_MIN_VERIFIED, after=lambda res, stats: keep(
                              "arm7 dense", scene, res, ARM_STEPS, 7,
                              ARM_MIN_VERIFIED))
    nlp = prob.build()
    plan = bb.make_plan(*nlp_mod.structured_band(nlp), *nlp.block)
    shape = (plan.T, plan.D, plan.K, plan.R)
    cs, smem = fb.cluster_plan(*shape)
    print(f"arm7 block: QP shape (T, D, K, R) {shape}, block kernel in "
          f"clusters of {cs} ({smem} B of shared memory per block)")
    drive_path("arm7 block", prob.make_solve(discrete_params(),
                                             structured=True),
               scene, arm_table_batch, ARM_B, ARM_STEPS, 7, BLOCK_LAUNCHES,
               "admm_block_chunk_kernel", smi, None, profile=False)
    return launches, prim, calls


def hard_batch(seed: int, B: int, n_steps: int):
    return pr2ish_table_batch(seed, B, n_steps, hard_frac=HARD_FRAC)


def phase_hard_mix(smi: str) -> int:
    """bench.py's hard-mix line at full size: the flagship with 64 of 256
    lanes on borderline goals."""
    prob, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2)

    def lanes(res, stats):
        status = res.status.cpu().tolist()
        print("hard mix: lanes not converged (lane: status): " + (", ".join(
            f"{k}: {SQPStatus.NAMES[v]}" for k, v in enumerate(status)
            if v != SQPStatus.CONVERGED) or "none"))
        keep("hard mix", scene, res, 30, 8, MIN_VERIFIED)

    return drive_path("hard mix", prob.make_solve(flagship_params(),
                                                  structured=True),
                      scene, hard_batch, B, 30, 8, BLOCK_LAUNCHES,
                      "admm_block_chunk_kernel", smi, MIN_VERIFIED,
                      n_hard=int(np.ceil(HARD_FRAC * B)), after=lanes)


def phase_family(smi: str) -> int:
    """The hard mix's measured batch with two restarts, the last one
    re-seeded from the multi-start family (bench.py's
    BENCH_RESTART_FAMILY line with BENCH_RESTARTS=2), one solve."""
    prob, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2)
    solve = prob.make_solve(dataclasses.replace(flagship_params(),
                                                max_restarts=2),
                            structured=True)
    inits, goals = hard_batch(1, B, 30)
    family = pr2ish_restart_family(goals, 30, rows=1)
    torch.cuda.synchronize()
    profiling.reset()
    t0 = time.time()
    res = solve(inits, {"goal": goals, "restart_inits": family})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _count(BLOCK_LAUNCHES)
    if tuple(res.x.shape) != (B, 240) or not bool(torch.isfinite(res.x).all()):
        raise SystemExit("family: trajectories not finite or of the wrong "
                         "shape")
    mins = swept_verify(scene, res.x.reshape(B, 30, 8))
    conv = res.status == SQPStatus.CONVERGED
    verified = conv & (mins > 0)
    n_ver = int(verified.sum())
    # every trust-region QP adds one exact evaluation, the start one and a
    # re-seed one more
    reseeded = int(((res.n_func_evals - res.n_qp_solves - 1) > 0).sum())
    print(f"family: converged {int(conv.sum())}/{B}, converged and "
          f"swept-verified {n_ver}/{B}, re-seeded lanes {reseeded}, mean SQP "
          f"iterations {float(res.n_iter.float().mean()):.2f}; {wall:.3f} s "
          f"-> {n_ver / wall:.2f} verified solves/s on {smi}; kernel "
          f"launches {launches}")
    print_outcome("family", res, verified, int(np.ceil(HARD_FRAC * B)))
    if launches <= 0:
        raise SystemExit("family: the solve never launched its kernel")
    if n_ver < MIN_VERIFIED:
        raise SystemExit(f"family: only {n_ver}/{B} lanes converged and "
                         f"verified (< {MIN_VERIFIED})")
    return launches


def first_dense_qp(nlp, x, lb, ub, sqp: SQPParams):
    """A dense path's first QP on the lanes ``x [B, n]`` within bounds
    ``lb``, ``ub``: convexified at x with the initial merit coefficients,
    the trust box the initial size around x."""
    model = nlp_mod.convexify(nlp, x, {}, nlp_mod.linear_jacobians(nlp, x,
                                                                   {}))
    coeffs = x.new_full((x.shape[0], nlp_mod.num_cnt_groups(nlp)),
                        sqp.initial_merit_error_coeff)
    box = sqp.initial_trust_box_size
    return build_qp(nlp, model, coeffs, torch.maximum(lb, x - box),
                    torch.minimum(ub, x + box))


def dense_on_first_qp(label: str, qp, x0, cfg: ADMMConfig) -> dict:
    """The dense kernel on a path's first QP (``qp``, at ``x0``): held
    against its plain version, both timed, the bound computed; prints the
    cluster plan.  Returns max_abs_err, ms, plain_ms, bound_ms,
    bound_by."""
    args = dense.chunk_operands(qp, x0, cfg)
    kw = dict(sigma=cfg.sigma, alpha=cfg.alpha, n_iters=cfg.check_every)
    _, err = hold_dense(f"dense {label} first QP", args, kw)
    ms = cuda_ms(lambda: fd.chunk_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: fd.chunk_plain(*args, **kw), 5)
    flops = fd.chunk_flops(args[1], kw["n_iters"])
    nbytes = fd.chunk_bytes(args[1])
    bound_ms, bound_by, t_ops, t_bytes = bound(flops, nbytes)
    B, m, n = args[1].shape
    cs, smem = fd.cluster_plan(n, m)
    clusters = fd.max_active_clusters(n, m)
    print(f"dense chunk on the {label} first QP, B={B}, n={n}, m={m}, "
          f"{kw['n_iters']} iterations: clusters of {cs} ({smem} B of "
          f"shared memory per block), at most {clusters} resident "
          f"(cudaOccupancyMaxActiveClusters) -> {B / clusters:.2f} waves; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP -> "
          f"{t_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def json_first_qp(jp, inits: torch.Tensor):
    """The reach document's first QP on the lanes ``inits [B, T, 7]``.
    Returns (QPData, x)."""
    x = inits.reshape(inits.shape[0], -1)
    return first_dense_qp(jp.prob.build(), x, *jp.prob.bounds(x), jp.sqp), x


def phase_json(smi: str) -> dict:
    """Phase 10: the JSON front end on arm7 (see the module doc)."""
    env = arm7_env()
    tree, scene = env.tree, env.scene

    # (a) examples/plan_arm.py's flow on the port's arm_table.json
    jp = load_problem_file(str(ARM_TABLE_JSON), env)
    with tempfile.TemporaryDirectory() as tmp:
        jp.log_results, jp.log_dir = True, tmp
        profiling.reset()
        t0 = time.time()
        res = jp.solve()
        torch.cuda.synchronize()
        wall = time.time() - t0
        logs = {f: Path(tmp, f).read_text().splitlines()
                for f in ("trajopt_solver.log", "trajopt_vars.log")}
    ok, dmin = check_trajectory(scene, res.x.reshape(jp.prob.n_steps, 7),
                                substeps=4)
    status = int(res.status[0])
    print(f"json arm_table.json: status {SQPStatus.NAMES[status]}, "
          f"iterations {int(res.n_iter[0])}, qp solves "
          f"{int(res.n_qp_solves[0])}; independent collision check: "
          f"free={ok} min_clearance={dmin:.4f}; {wall:.2f} s, "
          f"{_count(DENSE_LAUNCHES)} dense kernel launches; logs: solver "
          f"{len(logs['trajopt_solver.log'])} lines, vars "
          f"{len(logs['trajopt_vars.log'])} lines")
    if status != SQPStatus.CONVERGED or not ok or _count(DENSE_LAUNCHES) == 0:
        raise SystemExit("json arm_table.json: not converged, not free or "
                         "no kernel launch")
    if len(logs["trajopt_solver.log"]) != int(res.n_iter[0]) + 1 or \
            len(logs["trajopt_vars.log"]) != int(res.n_iter[0]):
        raise SystemExit("json arm_table.json: the CSV logs miss rows")

    # (b) the reach document at full width, B lanes of seeded inits
    jp = construct_problem(reach_document(REACH_STEPS), env)
    nlp = jp.prob.build()
    n, m = nlp.n, num_qp_rows(nlp)
    cs, smem = fd.cluster_plan(n, m)
    print(f"json reach: {REACH_STEPS} steps, n {n}, m {m}, dense kernel "
          f"in clusters of {cs} ({smem} B of shared memory per block); "
          f"settings: qp eps {jp.sqp.qp.eps_abs:g}, max_iter "
          f"{jp.sqp.qp.max_iter}, check_every {jp.sqp.qp.check_every}, "
          f"adaptive rho {jp.sqp.qp.adaptive_rho}")
    solve = jp.prob.make_solve(jp.sqp)
    t0 = time.time()
    solve(arm_table_batch(0, REACH_B, REACH_STEPS)[0])
    torch.cuda.synchronize()
    print(f"json reach: warm-up solve {time.time() - t0:.2f} s")
    inits, _ = arm_table_batch(1, REACH_B, REACH_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    t0 = time.time()
    res = solve(inits)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _count(DENSE_LAUNCHES)
    if tuple(res.x.shape) != (REACH_B, n) or \
            not bool(torch.isfinite(res.x).all()):
        raise SystemExit("json reach: trajectories not finite or of the "
                         "wrong shape")
    traj = res.x.reshape(REACH_B, REACH_STEPS, 7)
    perr = pose_error(tree, traj, REACH_STEPS - 1)
    free, dmins = check_trajectory(scene, traj, margin=0.0, substeps=20)
    conv = res.status == SQPStatus.CONVERGED
    verified = conv & free
    n_conv, n_ver = int(conv.sum()), int(verified.sum())
    print(f"json reach: per-lane status "
          + "".join(str(int(v)) for v in res.status.tolist()))
    print(f"json reach: per-lane check_trajectory (substeps 20, margin 0) "
          + "".join("." if v else "x" for v in free.tolist())
          + f"; min clearance {float(dmins.min()):+.4f}")
    print(f"json reach: pose error at step {REACH_STEPS - 1}: converged "
          f"lanes max {float(perr[conv].max()) if n_conv else float('nan'):.2e}"
          f", all lanes max {float(perr.max()):.2e}")
    print(f"json reach: converged {n_conv}/{REACH_B}, converged and checked "
          f"free {n_ver}/{REACH_B}, mean SQP iterations "
          f"{float(res.n_iter.float().mean()):.2f}, mean QP solves "
          f"{float(res.n_qp_solves.float().mean()):.2f}, statuses "
          f"{torch.bincount(res.status.cpu().long(), minlength=5).tolist()}")
    print(f"json reach: {wall:.3f} s for {REACH_B} lanes -> "
          f"{n_ver / wall:.2f} verified solves/s on {smi}; dense kernel "
          f"launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches <= 0:
        raise SystemExit("json reach: the solve never launched the kernel")
    if n_ver < ARM_MIN_VERIFIED:
        raise SystemExit(f"json reach: only {n_ver}/{REACH_B} lanes "
                         f"converged and checked free "
                         f"(< {ARM_MIN_VERIFIED})")
    profile_solve("json reach", lambda: solve(inits), "admm_dense_",
                  launches)

    # (c) the dense kernel on (b)'s first QP
    qp, x0 = json_first_qp(jp, inits)
    chunk = dense_on_first_qp("reach document's", qp, x0, jp.sqp.qp)

    # (d) MPC: three cycles of the arm7 workload with a drifting goal
    prob, _ = arm_table_problem(n_steps=ARM_STEPS)
    step = make_mpc_step(prob, discrete_params(), reinit_goal_key="goal")
    traj, goals = arm_table_batch(2, REACH_B, ARM_STEPS)
    for cycle in range(3):
        profiling.reset()
        t0 = time.time()
        traj, res = step(traj, {"goal": goals + 0.01 * cycle})
        torch.cuda.synchronize()
        n_conv = int((res.status == SQPStatus.CONVERGED).sum())
        print(f"mpc cycle {cycle}: converged {n_conv}/{REACH_B}, "
              f"{time.time() - t0:.2f} s, mean SQP iterations "
              f"{float(res.n_iter.float().mean()):.2f}, "
              f"{_count(DENSE_LAUNCHES)} dense kernel launches")
        if not bool(torch.isfinite(traj).all()) or \
                tuple(traj.shape) != (REACH_B, ARM_STEPS, 7):
            raise SystemExit(f"mpc cycle {cycle}: trajectories not finite "
                             f"or of the wrong shape")
        if n_conv < ARM_MIN_VERIFIED:
            raise SystemExit(f"mpc cycle {cycle}: only {n_conv}/{REACH_B} "
                             f"converged")
    return {"json_launches": launches,
            **{f"json_{k}": v for k, v in chunk.items()}}


# Unified narrowphase against the primitive kernels where the primitive
# distance is > -0.02 (near contact or separated), as the JAX package's
# tests/test_convex.py holds the discrete distances.
UNIFY_TOL, UNIFY_NEAR = 5e-4, -0.02
# Card against CPU in float64 on the convex narrowphase: the same
# elementwise arithmetic on both, but sums and the backward's scatter-adds
# round in another order (measured: distances within ~5e-16, Jacobians
# within ~3e-10; PERF.md).
F64_TOL = 1e-9


def unified_problem(device=None):
    return pr2ish_table_problem(n_steps=30, lvs_substeps=2,
                                unify_narrowphase=True, device=device)


def phase_unified(smi: str) -> tuple[int, int]:
    """(a) The flagship under ``unify_narrowphase``: all 91 pairs through
    the convex GJK + SAT narrowphase, B = 256, block path; checked with the
    primitive scene's swept check.  The search kernel runs inside the
    captured regions (init, convexify, evaluate), where its wrapper is
    called while a region is warmed up and captured, not when it is
    replayed: its launches are counted over the path's first solve (which
    makes the captures) and traced by name in the profiled repeat.
    Returns (block kernel launches of the measured solve, search kernel
    launches of the first solve)."""
    prob, uscene = unified_problem()
    _, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2)

    def against_primitive(res, stats):
        keep("unified flagship", uscene, res, 30, 8, MIN_VERIFIED)
        traj = res.x.reshape(B, 30, 8)
        fr = torch.linspace(0.0, 1.0, 3, dtype=traj.dtype,
                            device=traj.device)
        a, b = traj[:, :-1], traj[:, 1:]
        q = a[:, :, None, :] + fr[:, None] * (b - a)[:, :, None, :]
        with torch.no_grad():
            R, p = scene.tree.fk(q)
            f0, f1 = (R[:, :, :-1], p[:, :, :-1]), (R[:, :, 1:], p[:, :, 1:])
            sp, su = (sc.swept_distances(f0, f1) for sc in (scene, uscene))
            fk = scene.tree.fk(traj)
            dp, du = (sc.distances(fk) for sc in (scene, uscene))
        for what, ref, got in (("swept, the solve's LVS sub-segments", sp,
                                su), ("discrete, the waypoints", dp, du)):
            near = ref > UNIFY_NEAR
            err = float((got - ref).abs()[near].max())
            print(f"unified flagship: unified vs primitive {what}: max "
                  f"|diff| {err:.3e} over {int(near.sum())} of "
                  f"{ref.numel()} queries with primitive d > {UNIFY_NEAR}; "
                  f"signs differ on {int(((got < 0) != (ref < 0)).sum())}")
        if not err <= UNIFY_TOL:
            raise SystemExit(f"unified flagship: discrete distances differ "
                             f"from the primitive kernels' by {err:.3e}")

    solve = prob.make_solve(flagship_params(), structured=True)
    inits, goals = pr2ish_table_batch(1, B, 30)
    torch.cuda.synchronize()
    profiling.reset()
    t0 = time.time()
    solve(inits, {"goal": goals})
    torch.cuda.synchronize()
    convex = _count(CONVEX_LAUNCHES)
    print(f"unified flagship: first solve {time.time() - t0:.2f} s "
          f"({aot_cache.STATS}); {fc.KERNEL} launched {convex} times")
    if convex <= 0:
        raise SystemExit("unified flagship: the convex search kernel never "
                         "launched")
    block = drive_path("unified flagship", solve, scene, pr2ish_table_batch,
                       B, 30, 8, BLOCK_LAUNCHES, "admm_block_chunk_kernel",
                       smi, MIN_VERIFIED, after=against_primitive)
    # A replay records no host range inside its graph, so the narrowphase's
    # share of device time is read from an eager profile (the same device
    # work as the captured solve's).
    with aot_cache.eager():
        profile_solve("unified flagship eager",
                      lambda: solve(inits, {"goal": goals}),
                      "admm_block_chunk_kernel", block)
    return block, convex


def narrowphase_f64(dev, dtype, n: int = 16, seed: int = 11):
    """The unified pr2ish scene's discrete and swept distances with their
    Jacobians at ``n`` seeded configuration pairs, on ``dev`` in
    ``dtype``, returned on the CPU in float64."""
    _, uscene = unified_problem(device="cpu")
    tree = uscene.tree
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(tree.lower + 0.05, tree.upper - 0.05, (n, 8))
    q1 = np.clip(q0 + 0.3 * rng.standard_normal((n, 8)), tree.lower,
                 tree.upper)
    q0, q1 = (torch.as_tensor(v, dtype=dtype, device=dev) for v in (q0, q1))
    out = [*uscene.distances_and_jac(tree.fk_with_axes(q0)),
           *uscene.swept_distances_and_jac(tree.fk_with_axes(q0),
                                           tree.fk_with_axes(q1))]
    return [t.double().cpu() for t in out]


@contextlib.contextmanager
def plain_search():
    """Within the block the convex narrowphase runs the plain search on
    any device (and counts no launch)."""
    saved = fc.select
    fc.select = fc.select_plain
    try:
        yield
    finally:
        fc.select = saved


def phase_unified_f64() -> None:
    """(b) The convex narrowphase on the card against the CPU, float64 (and
    float32 beside the CPU's own float32 error); on the card with the
    search kernel against the plain search, float64: d within F64_D_TOL,
    the Jacobians within F64_J_TOL."""
    names = ("d", "J", "swept d", "swept J0", "swept J1")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    ref = narrowphase_f64(cpu, torch.float64)
    profiling.reset()
    got = narrowphase_f64(cuda, torch.float64)
    launches = _count(CONVEX_LAUNCHES)
    with plain_search():
        plain = narrowphase_f64(cuda, torch.float64)
    kp = [float((g - p).abs().max()) for g, p in zip(got, plain)]
    print(f"unified narrowphase float64 on the card, search kernel "
          f"({launches} launches) vs plain search max |diff|: " + ", ".join(
              f"{n} {e:.2e}" for n, e in zip(names, kp))
          + f" (tolerances d {F64_D_TOL:.0e}, J {F64_J_TOL:.0e}); plain "
          f"search vs CPU: " + ", ".join(
              f"{n} {float((p - r).abs().max()):.2e}"
              for n, p, r in zip(names, plain, ref)))
    if launches <= 0:
        raise SystemExit("unified narrowphase float64: the search kernel "
                         "never launched")
    if not (max(kp[0], kp[2]) <= F64_D_TOL
            and max(kp[1], kp[3], kp[4]) <= F64_J_TOL):
        raise SystemExit("unified narrowphase float64: the search kernel and "
                         "the plain search differ")
    got32 = narrowphase_f64(cuda, torch.float32)
    cpu32 = narrowphase_f64(cpu, torch.float32)
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    print("unified narrowphase, 16 configurations x 91 pairs, card vs CPU "
          "float64 max |diff|: " + ", ".join(
              f"{n} {e:.2e}" for n, e in zip(names, errs))
          + "; card float32 vs CPU float64: " + ", ".join(
              f"{n} {float((g - r).abs().max()):.2e}"
              for n, g, r in zip(names, got32, ref))
          + "; CPU float32 vs CPU float64: " + ", ".join(
              f"{n} {float((g - r).abs().max()):.2e}"
              for n, g, r in zip(names, cpu32, ref)))
    if not max(errs) <= F64_TOL:
        raise SystemExit(f"unified narrowphase: card and CPU differ in "
                         f"float64 by {max(errs):.3e}")


def arm7_sdf_problem(n_steps: int, device):
    """arm7's capsules against its table scene (slab and post) known only
    through an SDF grid (2 cm cells), discrete collision constraints."""
    scene = arm7_scene(world_objects=False)
    boxes = [((0.35, 0.5, 0.05), (0.55, 0.0, 0.25)),
             ((0.05, 0.05, 0.30), (0.39, 0.03, 1.00))]

    def world(pts):
        kw = dict(dtype=pts.dtype, device=pts.device)
        return torch.stack([point_box_sdf(pts - torch.as_tensor(c, **kw),
                                          torch.as_tensor(h, **kw))
                            for h, c in boxes]).amin(0)

    scene.add_world_sdf("world", bake_sdf(world, [-0.3, -0.9, -0.1],
                                          [1.3, 0.9, 1.5], 0.02))
    tree = arm7()
    prob = TrajOptProblem(n_steps=n_steps, n_dof=7, joint_lower=tree.lower,
                          joint_upper=tree.upper, fixed_steps=[0],
                          device=device)
    prob.add_term(joint_vel(n_steps, 7, is_cost=True, coeffs=np.full(7, 5.0)))
    prob.add_term(joint_pos(n_steps, 7, is_cost=False, targets="goal",
                            first_step=n_steps - 1, last_step=n_steps - 1))
    prob.add_term(collision_term(scene, n_steps, margin=0.025, coeff=20.0,
                                 is_cost=False, fixed_steps=[0]))
    return prob, scene


ARM6_HOME = np.array([0.0, -1.2, 1.6, -0.4, 1.57, 0.0])
ARM6_GOAL = np.array([0.9, -1.0, 1.4, -0.4, 1.57, 0.3])


def collision_scene_solve(path: str, dev, mesh_dir: str):
    """A small float32 solve on ``dev`` with discrete_params() on the dense
    path, 3 lanes: ``"arm6"`` (its shelf scene, 6 steps, as the JAX
    package's tests/test_arm6.py), ``"mesh"`` (the mesh arm, hulls from
    STL files through scene_from_urdf, 8 steps), ``"arm7 sdf"`` (10 steps
    against the baked SDF world), ``"simple"`` (simple_collision_problem,
    1 step).  Returns (status, SQP iterations, QP solves, x) on the CPU
    and the scene (None but for the mesh arm)."""
    rng = np.random.default_rng(3)
    kw = dict(dtype=torch.float32, device=dev)
    params, scene = {}, None
    if path == "simple":
        prob, _ = simple_collision_problem(device=dev)
        x0 = torch.as_tensor([[-0.75, 0.75], [-0.7, 0.8], [0.6, -0.7]], **kw)
    else:
        if path == "arm6":
            n, home, goal = 6, ARM6_HOME, ARM6_GOAL
            tree = arm6()
            prob = TrajOptProblem(n_steps=n, n_dof=6, joint_lower=tree.lower,
                                  joint_upper=tree.upper, fixed_steps=[0],
                                  device=dev)
            prob.add_term(joint_vel(n, 6, is_cost=True,
                                    coeffs=np.full(6, 5.0)))
            prob.add_term(joint_pos(n, 6, is_cost=False, targets="goal",
                                    first_step=n - 1, last_step=n - 1))
            prob.add_term(collision_term(arm6_scene(), n, margin=0.02,
                                         coeff=20.0, is_cost=False,
                                         fixed_steps=[0]))
            scale = 0.05
        elif path == "mesh":
            n, home, goal = 8, MESH_ARM_HOME, MESH_ARM_GOAL
            prob, scene = mesh_arm_problem(mesh_dir, n, device=dev)
            scale = 0.05
        else:
            n, home, goal = 10, ARM7_HOME, ARM7_GOAL
            prob, _ = arm7_sdf_problem(n, dev)
            scale = ARM7_GOAL_SCALE
        goals = torch.as_tensor(goal + scale * rng.standard_normal(
            (3, len(goal))), **kw)
        x0 = interpolated_init(torch.as_tensor(home, **kw).expand_as(goals),
                               goals, n).reshape(3, -1)
        params = {"goal": goals}
    res = make_solver(prob.build(), discrete_params())(x0, *prob.bounds(x0),
                                                        params)
    return [t.cpu() for t in (res.status, res.n_iter, res.n_qp_solves,
                              res.x)] + [scene]


@contextlib.contextmanager
def gjk_census(steps: dict):
    """Within the block, every convex search call on the card made outside
    a CUDA graph capture (eager, or a region's warm-up) adds its queries'
    GJK steps to the fixed point (``fused_convex.gjk_steps``: plain
    PyTorch, no launch) to ``steps[(A, B)]``."""
    saved = fc.select

    def census(Va, Vb, axes, valid, cax, iters=cvx.GJK_ITERS):
        out = saved(Va, Vb, axes, valid, cax, iters)
        if Va.is_cuda and not torch.cuda.is_current_stream_capturing():
            key = (Va.shape[-2], Vb.shape[-2])
            got = fc.gjk_steps(Va, Vb, iters).flatten()
            steps[key] = torch.cat([steps[key], got]) if key in steps \
                else got
        return out

    fc.select = census
    try:
        yield steps
    finally:
        fc.select = saved


def phase_collision_scenes() -> tuple[int, int]:
    """(c) Small solves of the other collision scenes, card (float32,
    kernels) against the CPU (float32, plain versions): equal statuses.
    The mesh arm's hull pairs run the convex search kernel.  Returns the
    dense kernel's and the search kernel's launches on the card."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    launches = convex = 0
    with tempfile.TemporaryDirectory() as tmp:
        write_mesh_arm(tmp)
        for path in ("arm6", "mesh", "arm7 sdf", "simple"):
            profiling.reset()
            t0 = time.time()
            with gjk_census({}) as steps:
                gpu = collision_scene_solve(path, cuda, tmp)
            t_card = time.time() - t0
            for (A, Bv), st in sorted(steps.items()):
                print_gjk_steps(f"collision scene solve ({path}), search "
                                f"calls of A {A}, B {Bv}", st)
            launches += _count(DENSE_LAUNCHES)
            convex += _count(CONVEX_LAUNCHES)
            ref = collision_scene_solve(path, cpu, tmp)
            names = ("status", "SQP iterations", "QP solves")
            print(f"collision scene solve ({path}, 3 lanes, float32): card "
                  f"{t_card:.2f} s, {_count(DENSE_LAUNCHES)} dense kernel "
                  f"launches, {_count(CONVEX_LAUNCHES)} convex search kernel "
                  f"launches; card vs CPU " + ", ".join(
                      f"{n} {g.tolist()} vs {c.tolist()}"
                      for n, g, c in zip(names, gpu, ref))
                  + f"; max |dx| {float((gpu[3] - ref[3]).abs().max()):.3e}")
            if _count(DENSE_LAUNCHES) == 0:
                raise SystemExit(f"{path} solve did not launch the dense "
                                 f"kernel")
            if path == "mesh" and _count(CONVEX_LAUNCHES) == 0:
                raise SystemExit("mesh solve did not launch the convex "
                                 "search kernel")
            if path == "mesh":
                lanes, n_steps = gpu[3].shape[0], gpu[3].shape[1] // 2
                FINAL["mesh arm"] = (gpu[4], gpu[3].reshape(
                    lanes, n_steps, 2).to(cuda), gpu[0].to(cuda), None)
            if not torch.equal(gpu[0], ref[0]):
                raise SystemExit(f"{path} solve: statuses differ between "
                                 f"card and CPU")
    return launches, convex


# Phase 12: the PR2 planning problem through the ifopt model on the dense
# path: n 240, m 335 (29 gaps x 3 rows, 8 goal rows, 240 box rows).
IFOPT_STEPS, IFOPT_B = 30, 64
IFOPT_MIN_VERIFIED = 61     # of 64 lanes: 95 %
IFOPT_NOISE = 0.05          # rad, on the starts' interior steps
# The batched solver against the host reference driver: the backend parity
# budget of tests/test_backend_parity.py.
REF_XTOL = 1e-3
# The batch split: arm7, 10 steps, B = 32 (block path, as the JAX
# package's make_sharded_batch_solver); on several cards x within the JAX
# test's 5e-4 (each card solves a smaller batch), on one card equal.
SPLIT_STEPS, SPLIT_B, SPLIT_XTOL = 10, 32, 5e-4
# The device phase 12 runs on (a CPU rehearsal of the phase points it at
# the CPU).
CARD = "cuda"


def ifopt_pr2_problem(n_steps: int = IFOPT_STEPS):
    """The PR2 planning problem through the ifopt component model: pr2ish
    (8 DOF, 91 pairs), one ``NodesVariables`` node of 8 ``position``
    variables a step within the joint limits, the start pinned at home by
    equal bounds; cost ``SquaredCost(JointVelConstraint(0, coeffs 5))``;
    constraints ``JointPosConstraint`` to ``pr2ish_goals(0, 1)[0]`` at the
    last node and a ``ContinuousCollisionConstraint`` a gap (margin 0.025,
    coeff 20, LVS 2, the ifopt default of 3 rows).  Returns (problem,
    scene, goal, the straight-line init [n_steps, 8])."""
    tree, scene = pr2ish(), pr2ish_scene()
    goal = pr2ish_goals(0, 1)[0]
    w = np.linspace(0.0, 1.0, n_steps)[:, None]
    init = PR2ISH_HOME * (1.0 - w) + goal * w
    lower = np.tile(tree.lower, n_steps)
    upper = np.tile(tree.upper, n_steps)
    lower[:8] = upper[:8] = PR2ISH_HOME
    prob = ifopt.Problem()
    nodes = []
    for t in range(n_steps):
        nd = ifopt.Node(f"step{t}")
        nd.add_var("position", 8)
        nodes.append(nd)
    nv = prob.add_variable_set(ifopt.NodesVariables(
        "trajectory", nodes, init.reshape(-1), lower, upper))
    pos = [nv.node_var(t, "position") for t in range(n_steps)]
    prob.add_cost_set(ifopt.SquaredCost(
        ifopt.JointVelConstraint(np.zeros(8), pos, coeffs=5.0)))
    prob.add_constraint_set(ifopt.JointPosConstraint(goal, [pos[-1]],
                                                     name="goal"))
    for t in range(n_steps - 1):
        prob.add_constraint_set(ifopt.ContinuousCollisionConstraint(
            scene, pos[t], pos[t + 1], margin=0.025, coeff=20.0,
            lvs_substeps=2, max_num_cnt=3, name=f"collision{t}"))
    return prob, scene, goal, init


def ifopt_starts(init: np.ndarray, B: int, seed: int) -> np.ndarray:
    """[B, n] starts: the straight line plus seeded normal noise of
    IFOPT_NOISE rad on the interior steps."""
    noise = IFOPT_NOISE * np.random.default_rng(seed).standard_normal(
        (B, *init.shape))
    noise[:, 0] = noise[:, -1] = 0.0
    return (init[None] + noise).reshape(B, -1)


def ifopt_outcome(label, scene, res, goal, B, n_steps):
    """(converged, converged and swept-verified) lanes, printed with the
    worst clearance, goal error and counts."""
    if tuple(res.x.shape) != (B, n_steps * 8) or \
            not bool(torch.isfinite(res.x).all()):
        raise SystemExit(f"{label}: trajectories not finite or of the wrong "
                         f"shape")
    traj = res.x.reshape(B, n_steps, 8)
    mins = swept_verify(scene, traj)
    conv = res.status == SQPStatus.CONVERGED
    n_conv, n_ver = int(conv.sum()), int((conv & (mins > 0)).sum())
    g = torch.as_tensor(goal, dtype=traj.dtype, device=traj.device)
    goal_err = (float((traj[conv, -1] - g).abs().max()) if n_conv
                else float("nan"))
    print(f"{label}: converged {n_conv}/{B}, converged and swept-verified "
          f"{n_ver}/{B}, worst clearance {float(mins.min()):+.4f}, max goal "
          f"error {goal_err:.2e}, mean SQP iterations "
          f"{float(res.n_iter.float().mean()):.2f}, mean QP solves "
          f"{float(res.n_qp_solves.float().mean()):.2f}, statuses "
          f"{torch.bincount(res.status.cpu().long(), minlength=5).tolist()}")
    return n_conv, n_ver


def ifopt_paths(smi: str, sqp: SQPParams) -> tuple[dict, object, object]:
    """(a): the ifopt problem once through ``Problem.solve()`` and on B
    noisy starts through ``make_solver``.  Returns (kernel numbers, the
    problem, the single solve's result)."""
    dev = torch.device(CARD)
    prob, scene, goal, init = ifopt_pr2_problem(IFOPT_STEPS)
    nlp = prob.build()
    n, m = nlp.n, num_qp_rows(nlp)
    cs, smem = fd.cluster_plan(n, m)
    print(f"ifopt: {IFOPT_STEPS} nodes, {len(nlp.term_sets)} term sets, n "
          f"{n}, m {m}, dense kernel in clusters of {cs} ({smem} B of "
          f"shared memory per block)")

    profiling.reset()
    t0 = time.time()
    single, values = prob.solve(sqp, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_conv, n_ver = ifopt_outcome(
        "ifopt single (Problem.solve)", scene,
        single._replace(**{f: v[None] for f, v in single._asdict().items()}),
        goal, 1, IFOPT_STEPS)
    print(f"ifopt single: status {SQPStatus.NAMES[int(single.status)]}, "
          f"{int(single.n_iter)} SQP iterations, {int(single.n_qp_solves)} "
          f"QP solves, {wall:.2f} s, {_count(DENSE_LAUNCHES)} dense kernel "
          f"launches; values by set: "
          f"{ {k: v.shape for k, v in values.items()} }")
    if n_ver != 1:
        raise SystemExit("ifopt single: not converged or not free")

    kw = dict(dtype=torch.float32, device=dev)
    x0 = torch.as_tensor(ifopt_starts(init, IFOPT_B, 1), **kw)
    lo, hi = (torch.as_tensor(b, **kw).expand(IFOPT_B, n)
              for b in prob.bounds())
    solver = make_solver(nlp, sqp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    t0 = time.time()
    res = solver(x0, lo, hi, {})
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _count(DENSE_LAUNCHES)
    n_conv, n_ver = ifopt_outcome("ifopt batch", scene, res, goal, IFOPT_B,
                                  IFOPT_STEPS)
    print(f"ifopt batch: {wall:.3f} s for {IFOPT_B} lanes -> "
          f"{n_ver / wall:.2f} verified solves/s on {smi}; dense kernel "
          f"launches {launches} (clusters of {cs}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches <= 0:
        raise SystemExit("ifopt batch: the solve never launched the kernel")
    if n_ver < IFOPT_MIN_VERIFIED:
        raise SystemExit(f"ifopt batch: only {n_ver}/{IFOPT_B} lanes "
                         f"converged and verified (< {IFOPT_MIN_VERIFIED})")
    profile_solve("ifopt batch", lambda: solver(x0, lo, hi, {}),
                  "admm_dense_", launches)
    chunk = dense_on_first_qp("ifopt path's", first_dense_qp(
        nlp, x0, lo, hi, sqp), x0, sqp.qp)
    return ({"ifopt_launches": launches,
             **{f"ifopt_{k}": v for k, v in chunk.items()}}, prob, single)


def reference_path(prob, sqp: SQPParams, single) -> None:
    """(b): the host reference driver on (a)'s problem, convexify on the
    card, against (a)'s single solve."""
    t0 = time.time()
    ref = solve_reference(prob.build(), prob.initial_values(),
                          *prob.bounds(), {}, sqp, device=CARD)
    wall = time.time() - t0
    dx = float(np.abs(ref.x - single.x.double().cpu().numpy()).max())
    print(f"reference driver: status {SQPStatus.NAMES[ref.status]}, "
          f"{ref.n_iter} SQP iterations, {ref.n_qp_solves} native QP "
          f"solves, {wall:.2f} s; against the single solve (status "
          f"{SQPStatus.NAMES[int(single.status)]}): max |dx| {dx:.3e}, "
          f"tolerance {REF_XTOL:g}")
    if ref.status != int(single.status) or not dx <= REF_XTOL:
        raise SystemExit("reference driver: status or x differs from the "
                         "batched solver's single solve")


def split_paths(prob, sqp: SQPParams, inits, params):
    """(c) the batch split over every visible card against the unsplit
    solve; (d) a profiler trace and Timer around it.  Returns the split
    solve's result."""
    devices = data_parallel_mesh()
    split = make_sharded_batch_solver(prob, devices, sqp)
    whole = prob.make_solve(sqp, structured=True)(inits, params)
    t0 = time.time()
    res = split(inits, params)
    torch.cuda.synchronize()
    wall = time.time() - t0
    dx = float((res.x - whole.x).abs().max())
    same = bool(torch.equal(res.status, whole.status))
    print(f"batch split over {len(devices)} card(s) {devices}: {wall:.2f} "
          f"s, statuses equal to the unsplit solve: {same}, max |dx| "
          f"{dx:.3e}; summarize: {summarize(res)}")
    exact = len(devices) == 1
    if not same or not (torch.equal(res.x, whole.x) if exact
                        else dx <= SPLIT_XTOL):
        raise SystemExit("batch split: differs from the unsplit solve")

    with tempfile.TemporaryDirectory() as tmp:
        log_dir = str(Path(tmp, "trace"))
        with trace(log_dir):
            with Timer() as timer:
                timer.observe(split(inits, params))
        files = list(Path(log_dir).iterdir())
        events = json.loads(files[0].read_text())["traceEvents"] \
            if len(files) == 1 else []
        kernels = sum(e.get("cat") == "kernel" for e in events)
        print(f"profiling.trace: {len(files)} file(s), {len(events)} events, "
              f"{kernels} CUDA kernel events; Timer {timer.elapsed:.3f} s")
        if not kernels or not timer.elapsed > 0:
            raise SystemExit("profiling.trace: no kernel events in the "
                             "trace, or no time")
    return res


def utils_paths(prob, sqp: SQPParams, inits, params, res) -> None:
    """(e) the failed-QP dump of a solve cut at one SQP iteration, and a
    checkpoint round trip of (c)'s result."""
    with tempfile.TemporaryDirectory() as tmp:
        early = prob.make_solve(dataclasses.replace(sqp, max_iter=1))(
            inits, params)
        statuses = sorted(set(early.status.tolist()))
        path = str(Path(tmp, "fail.npz"))
        n_dumped = dump_failed_qps(prob.build(), early, params, path,
                                   statuses=statuses)
        with np.load(path) as blob:
            lanes = blob["failed_lanes"]
            fields = ("P", "q", "c0", "A_cost", "b_cost", "w_cost", "A_cnt",
                      "b_cnt", "u_cnt", "x", "merit_coeffs")
            keys_ok = all(f"lane{i}_{f}" in blob.files
                          for i in lanes for f in (*fields, "l_cnt",
                                                   "status"))
            finite = all(np.isfinite(blob[f"lane{i}_{f}"]).all()
                         for i in lanes for f in fields)
            lower_ok = all(not np.isnan(blob[f"lane{i}_l_cnt"]).any()
                           for i in lanes)
        print(f"dump_failed_qps (max_iter 1, statuses "
              f"{[SQPStatus.NAMES[s] for s in statuses]}): {n_dumped} lanes, "
              f"keys {keys_ok}, finite {finite and lower_ok}")
        if n_dumped < 1 or len(lanes) != n_dumped or not (
                keys_ok and finite and lower_ok):
            raise SystemExit("dump_failed_qps: lanes, keys or values wrong")

        path = str(Path(tmp, "result.npz"))
        save_result(path, res, params)
        back, extra = load_result(path)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(res, back)) and \
            torch.equal(extra["goal"], params["goal"].cpu())
        print(f"checkpoint round trip: equal {same}")
        if not same:
            raise SystemExit("checkpoint: the loaded result differs")


def phase_ifopt_host(smi: str) -> dict:
    """Phase 12: the ifopt and host paths (see the module doc)."""
    sqp = discrete_params()
    t0 = time.time()
    out, prob, single = ifopt_paths(smi, sqp)
    print(f"phase 12 (a) ifopt: {time.time() - t0:.1f} s")
    t0 = time.time()
    reference_path(prob, sqp, single)
    print(f"phase 12 (b) reference driver: {time.time() - t0:.1f} s")
    t0 = time.time()
    prob, _ = arm_table_problem(n_steps=SPLIT_STEPS, device=CARD)
    inits, goals = arm_table_batch(3, SPLIT_B, SPLIT_STEPS, device=CARD)
    res = split_paths(prob, sqp, inits, {"goal": goals})
    utils_paths(prob, sqp, inits, {"goal": goals}, res)
    print(f"phase 12 (c-e) split, trace, dump, checkpoint: "
          f"{time.time() - t0:.1f} s")
    return out


# Phase 13: captured against eager.  Float32 solves of one batch sum in
# another order when a region runs at another lane bucket (batched GEMM
# shapes), so the two runs are held to statuses on all but 1 % of the
# lanes and converged lanes' x within 1e-3, not to bit equality.  Float64
# small references: captured card against CPU to 1e-9.
CAPTURE_STATUS_FRAC = 0.01
CAPTURE_XTOL = 1e-3
F64_XTOL = 1e-9


@contextlib.contextmanager
def plain_chunks():
    """Within the block both chunk wrappers run their plain versions on
    any device (and count no launch): float64 on the card."""
    def block(*args, active=None, **kw):
        state, stats = fb.chunk_plain(*args, **kw)
        if active is None:
            return state, stats
        state = tuple(torch.where(active[:, None], new, old)
                      for new, old in zip(state, args[15:]))
        return state, type(stats)(*(torch.where(active, v, torch.nan)
                                    for v in stats))

    saved = fb.chunk
    fb.chunk = block
    try:
        with plain_dense_chunk():
            yield
    finally:
        fb.chunk = saved


def captured_f64_references() -> None:
    """Phase 5's small references in float64, captured on the card (plain
    chunks) against the CPU: equal status and counts, x within F64_XTOL."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f64 = torch.float64
    cases = [(p, lambda dev, p=p: small_solve(p, dev, dtype=f64))
             for p in ("pr2ish", "hard", "hard rescale", "arm7", "arm7 ipm")]
    cases += [(p, lambda dev, p=p: small_json_solve(p, dev, dtype=f64))
              for p in ("arm_table.json", "reach")]
    names = ("status", "SQP iterations", "QP solves")
    for path, run in cases:
        aot_cache.STATS.reset()
        with plain_chunks():
            card = run(cuda)
        replays = aot_cache.STATS.replays
        ref = run(cpu)
        dx = float((card[3] - ref[3]).abs().max())
        print(f"captured float64 {path}: card vs CPU " + ", ".join(
            f"{n} {g.tolist()} vs {c.tolist()}"
            for n, g, c in zip(names, card, ref))
            + f"; max |dx| {dx:.3e} (tolerance {F64_XTOL:.0e}); replays "
            f"{replays}")
        if replays == 0:
            raise SystemExit(f"captured float64 {path}: nothing replayed")
        if not (all(torch.equal(g, c) for g, c in zip(card[:3], ref[:3]))
                and dx <= F64_XTOL):
            raise SystemExit(f"captured float64 {path}: card and CPU differ")


def compare_runs(label: str, eager, captured, B: int, hold: bool,
                 names=("eager", "captured")) -> None:
    """Statuses and converged lanes' x of one batch, eager against
    captured (or the two runs ``names`` names); every lane that differs is
    printed.  With ``hold`` fails when statuses differ on more than
    CAPTURE_STATUS_FRAC of the lanes or a lane converged in both differs
    by more than CAPTURE_XTOL."""
    st_e, st_c = eager.status.cpu(), captured.status.cpu()
    both = (st_e == SQPStatus.CONVERGED) & (st_c == SQPStatus.CONVERGED)
    dx = (eager.x - captured.x).abs().amax(-1).cpu()
    moved = torch.nonzero((st_e != st_c) | (both & (dx > CAPTURE_XTOL)))
    n_status = int((st_e != st_c).sum())
    a, b = names
    print(f"{label}: {b} vs {a}: statuses differ on {n_status}/{B} "
          f"lanes; converged lanes' max |dx| "
          f"{float(dx[both].max()) if bool(both.any()) else 0.0:.3e} "
          f"(tolerance {CAPTURE_XTOL:.0e}); SQP iterations {a} "
          f"{float(eager.n_iter.float().mean()):.2f}, {b} "
          f"{float(captured.n_iter.float().mean()):.2f}")
    for i in moved[:, 0].tolist():
        print(f"{label}: lane {i}: status {a} "
              f"{SQPStatus.NAMES[int(st_e[i])]}, {b} "
              f"{SQPStatus.NAMES[int(st_c[i])]}; SQP iterations "
              f"{int(eager.n_iter[i])} / {int(captured.n_iter[i])}; |dx| "
              f"{float(dx[i]):.3e}")
    if hold and n_status > CAPTURE_STATUS_FRAC * B:
        raise SystemExit(f"{label}: statuses differ on {n_status}/{B} lanes")
    if hold and bool((dx[both] > CAPTURE_XTOL).any()):
        raise SystemExit(f"{label}: converged lanes' x differ by more than "
                         f"{CAPTURE_XTOL}")


def phase_captured(smi: str) -> None:
    """Phase 13: the flagship, the hard mix and arm7 dense, each solved on
    one seeded batch under ``aot_cache.eager()`` and captured (wall time,
    verified solves/s, statuses, launches, capture counts, idle share and
    layer split), held against each other; then phase 5's
    small references captured in float64 against the CPU."""
    prob, scene = pr2ish_table_problem(n_steps=30, lvs_substeps=2)
    arm, arm_scene = arm_table_problem(n_steps=ARM_STEPS)
    paths = (
        ("flagship", prob, scene, flagship_params(), True, pr2ish_table_batch,
         B, 30, 8, BLOCK_LAUNCHES, "admm_block_chunk_kernel", 0, True),
        ("hard mix", prob, scene, flagship_params(), True, hard_batch, B, 30,
         8, BLOCK_LAUNCHES, "admm_block_chunk_kernel",
         int(np.ceil(HARD_FRAC * B)), False),
        ("arm7 dense", arm, arm_scene, discrete_params(), False,
         arm_table_batch, ARM_B, ARM_STEPS, 7, DENSE_LAUNCHES, "admm_dense_",
         0, True))
    for (label, pb, sc, params, structured, batch, nb, steps, dof, counter,
         kernel, n_hard, hold) in paths:
        runs = {}
        for mode in ("eager", "captured"):
            out = []
            with (aot_cache.eager() if mode == "eager"
                  else contextlib.nullcontext()):
                drive_path(f"{label} {mode}",
                           pb.make_solve(params, structured=structured),
                           sc, batch, nb, steps, dof, counter, kernel, smi,
                           MIN_VERIFIED if nb == B else ARM_MIN_VERIFIED,
                           n_hard=n_hard,
                           after=lambda res, stats: out.append((res, stats)))
            res, (captures, _, replays) = out[0]
            if mode == "eager" and replays:
                raise SystemExit(f"{label}: {replays} replays under eager()")
            if mode == "captured" and not replays:
                raise SystemExit(f"{label}: the captured solve replayed "
                                 f"nothing")
            runs[mode] = res
        compare_runs(label, runs["eager"], runs["captured"], nb, hold)
    captured_f64_references()


# Phase 14: the independent check (``trajopt_tpu_torch/external_verify.py``)
# of the final trajectories of every full-width path, kept by
# :func:`keep`: label -> (scene, trajectories [B, T, n_dof] on the card,
# statuses [B], the least number of lanes that must be certified free, or
# None: every lane the swept check verifies, and the same verdict on every
# lane).  The mesh arm's small solve takes None: its lanes step across the
# post between the points its LVS-discrete term checks (in the JAX package
# too), so both checks find them in collision.
FINAL: dict = {}
# A swept-verified sample may penetrate this deep (m) before the phase
# calls it a blind spot: the arc slack of 0.05 rad sub-segments on links up
# to about 1 m.  The swept check may exceed the exact sampled clearance by
# as much.
EXTERNAL_SLACK = 1e-3


def keep(label: str, scene, res, n_steps: int, n_dof: int, limit: int):
    """Keep a copy of a path's measured solve for phase 14."""
    FINAL[label] = (scene, res.x.reshape(-1, n_steps, n_dof).clone(),
                    res.status.clone(), limit)


def external_check(label: str, scene, traj, status,
                   limit: int | None) -> float:
    """Certify one path's converged lanes (:func:`ev.certify`, on the card)
    and hold the swept check (``swept_verify``, the hand kernels) against
    them.  Fails on a blind spot (a swept-verified lane with a sample the
    exact solver finds deeper than ``EXTERNAL_SLACK`` in collision), on
    fewer than ``limit`` lanes certified free (None: fewer than the swept
    check verifies, or another verdict on any lane), and when the swept check
    exceeds a lane's exact sampled clearance by more than
    ``EXTERNAL_SLACK``.  Returns the seconds it took."""
    t0 = time.time()
    conv = status == SQPStatus.CONVERGED
    lanes = torch.nonzero(conv).flatten().tolist()
    traj = traj[conv]
    mins = swept_verify(scene, traj)
    verdict = ev.certify(scene, traj,
                         log=lambda m: print(f"{label}: external {m[2:]}"))
    out = verdict.agreement(mins)
    print(f"{label}: external check {json.dumps(out)}")
    repo = mins.double().cpu().numpy()
    deep = [(lanes[k], pair, d) for k, pair, d in verdict.exact
            if repo[k] > 0 and d < -EXTERNAL_SLACK]
    # The certificates are lower bounds, loose by up to centimetres, so
    # diff_max above is positive; below the swept value each lane's values
    # are made tight (Verdict.refine).
    lows, n_local, n_exact, left = verdict.refine(repo)
    exact_diff = repo - lows
    print(f"{label}: swept check - tight sampled clearance in "
          f"[{exact_diff.min():+.6f}, {exact_diff.max():+.6f}] m ("
          f"{n_local} local direction searches, {n_exact} exact solves, "
          f"{left} left); max exact penetration "
          f"{verdict.max_exact_penetration:.6f} m; {time.time() - t0:.1f} s")
    if deep:
        lane, pair, d = min(deep, key=lambda e: e[2])
        raise SystemExit(f"{label}: blind spot: lane {lane} is converged "
                         f"and swept-verified, but the exact solver finds "
                         f"pair {pair} {-d:.6f} m deep in collision "
                         f"({len(deep)} such samples)")
    if limit is None:
        if out["agree"] < len(lanes):
            raise SystemExit(f"{label}: the swept check and the external "
                             f"check disagree on "
                             f"{len(lanes) - out['agree']} lanes")
        limit = int((repo > 0).sum())
    if out["external_free"] < limit:
        raise SystemExit(f"{label}: only {out['external_free']} of "
                         f"{len(lanes)} converged lanes certified free "
                         f"(< {limit})")
    if not exact_diff.max() <= EXTERNAL_SLACK:
        k = int(np.argmax(exact_diff))
        raise SystemExit(f"{label}: the swept check over-estimates lane "
                         f"{lanes[k]}'s clearance by {exact_diff[k]:.6f} m "
                         f"(> {EXTERNAL_SLACK:g}, {left} samples left "
                         f"uncertified)")
    return time.time() - t0


def phase_external(smi: str) -> None:
    """Phase 14 (see the module doc): every kept path through
    :func:`external_check`."""
    missing = {"flagship", "arm7 dense", "hard mix", "unified flagship",
               "mesh arm"} - set(FINAL)
    if missing:
        raise SystemExit(f"external check: no trajectories of {missing}")
    took = {label: external_check(label, *FINAL[label]) for label in FINAL}
    print("external check: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in took.items())
          + f"; {sum(took.values()):.1f} s in all on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.time()

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"phase {name}: {time.time() - t0:.1f} s (peak host memory "
              f"{rss:.1f} GiB)", flush=True)
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    block = timed("block kernel", phase_kernel_check, dev)
    dense_k = timed("dense kernel", phase_dense_kernel_check, dev)
    convex = timed("convex kernel", phase_convex_kernel_check, dev)
    prim = timed("primitive kernel", phase_primitive_kernel_check, dev)
    timed("small references", phase_small_reference)
    # the primitive kernel launches once a group: its "launches" count
    # kernel launches, its "query_calls" the wrapper's calls
    block["launches"], prim["launches"], prim["query_calls"] = timed(
        "flagship", phase_flagship, smi)
    (dense_k["launches"], prim["arm7_dense_launches"],
     prim["arm7_dense_query_calls"]) = timed("arm7", phase_arm7, smi)
    block["hard_mix_launches"] = timed("hard mix", phase_hard_mix, smi)
    block["family_launches"] = timed("family", phase_family, smi)
    dense_k.update(timed("json front end", phase_json, smi))
    block["unified_launches"], convex["launches"] = timed(
        "unified flagship", phase_unified, smi)
    timed("unified narrowphase float64", phase_unified_f64)
    (dense_k["collision_scene_launches"],
     convex["collision_scene_launches"]) = timed("collision scenes",
                                                 phase_collision_scenes)
    dense_k.update(timed("ifopt and host paths", phase_ifopt_host, smi))
    timed("captured against eager", phase_captured, smi)
    timed("external check", phase_external, smi)
    dense_k["max_abs_err"] = max(dense_k["max_abs_err"],
                                 dense_k["json_max_abs_err"],
                                 dense_k["ifopt_max_abs_err"])
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [block, dense_k, convex, prim]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
