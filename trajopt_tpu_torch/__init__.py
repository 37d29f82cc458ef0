"""PyTorch/CUDA port of trajopt_tpu: trust-region SQP trajectory optimization
with swept-volume collision constraints, written for one NVIDIA H100.

The module layout mirrors ``trajopt_tpu/`` so each counterpart is easy to
find; the code is PyTorch idiom (plain functions on batched tensors, batch on
the leading axis, per-lane active masks where the JAX package vmapped a
``lax.while_loop``).  Nothing here imports ``jax`` or ``trajopt_tpu``.

Device and precision policy:

* Entry points (``TrajOptProblem.make_solve``, ``pr2ish_table_problem``,
  ``pr2ish_table_batch``) run on ``cuda`` unless the caller passes
  ``device="cpu"``; without a CUDA device they raise instead of falling back.
* The device dtype is float32 with TF32 off: the ADMM and Cholesky
  tolerances (1e-4-level constraint decisions) do not survive short-mantissa
  matrix products.  The CPU tests run float64.
"""

from __future__ import annotations

import torch

DEVICE_DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The port's default device: the first CUDA device.  Raises when no
    CUDA device is present (pass ``device="cpu"`` explicitly instead)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "trajopt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> torch.device."""
    return default_device() if device is None else torch.device(device)


def resolve_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """Explicit dtype wins; otherwise float32 on the card, float64 on CPU."""
    if dtype is not None:
        return dtype
    return DEVICE_DTYPE if device.type == "cuda" else torch.float64


# Top-level convenience exports, the JAX package's ``__all__`` (plus
# ``dump_failed_qps``).  They load after the device helpers above, which
# the submodules import from here.
from trajopt_tpu_torch.collision.check import check_trajectory  # noqa: E402
from trajopt_tpu_torch.collision.sdf_grid import (  # noqa: E402
    SdfGrid, bake_sdf)
from trajopt_tpu_torch.collision.world import (  # noqa: E402
    CollGeom, CollisionScene, scene_from_urdf)
from trajopt_tpu_torch.kinematics.chain import (  # noqa: E402
    KinematicTree, build_tree)
from trajopt_tpu_torch.kinematics.ik import solve_ik  # noqa: E402
from trajopt_tpu_torch.kinematics.srdf import (  # noqa: E402
    SrdfModel, group_state_vector, load_srdf, parse_srdf,
    resolve_group_joints)
from trajopt_tpu_torch.kinematics.urdf import (  # noqa: E402
    load_urdf, parse_urdf)
from trajopt_tpu_torch.problem.json_io import (  # noqa: E402
    Environment, construct_problem, load_problem_file, register_term_type)
from trajopt_tpu_torch.problem.mpc import make_mpc_step  # noqa: E402
from trajopt_tpu_torch.problem.trajectory import (  # noqa: E402
    TrajOptProblem, given_init, interpolated_init, stationary_init)
from trajopt_tpu_torch.sqp.nlp import Kind, Nlp, TermSet  # noqa: E402
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus  # noqa: E402
from trajopt_tpu_torch.sqp.solver import SQPResult, make_solver  # noqa: E402
from trajopt_tpu_torch.terms.cartesian import (  # noqa: E402
    avoid_singularity, cart_line, cart_pose, cart_vel, dynamic_cart_pose,
    ik_constraint)
from trajopt_tpu_torch.terms.collision import collision_term  # noqa: E402
from trajopt_tpu_torch.terms.joint import (  # noqa: E402
    joint_acc, joint_jerk, joint_pos, joint_vel)
from trajopt_tpu_torch.terms.time import (  # noqa: E402
    joint_acc_time, joint_vel_time, total_time)
from trajopt_tpu_torch.utils.debug import dump_failed_qps  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "CollGeom", "CollisionScene", "Environment", "KinematicTree", "Kind",
    "Nlp", "SQPParams", "SQPResult", "SQPStatus", "SdfGrid", "TermSet",
    "TrajOptProblem", "avoid_singularity", "bake_sdf", "build_tree",
    "cart_line", "cart_pose", "cart_vel", "check_trajectory",
    "collision_term", "construct_problem", "dump_failed_qps",
    "dynamic_cart_pose", "given_init", "ik_constraint", "interpolated_init",
    "joint_acc", "joint_acc_time", "joint_jerk", "joint_pos", "joint_vel",
    "joint_vel_time", "load_problem_file", "load_urdf", "make_mpc_step",
    "make_solver", "parse_urdf", "register_term_type", "scene_from_urdf",
    "solve_ik", "stationary_init", "total_time",
]
