"""JSON problem front end: the reference's problem-document schema.

Counterpart of ``trajopt_tpu/problem/json_io.py`` (the reference's
``ProblemConstructionInfo::fromJson`` / ``ConstructProblem``), with the
same document schema and the same rejections:

  basic_info:  n_steps, manip, fixed_timesteps, fixed_dofs, use_time,
               dt_lower_lim, dt_upper_lim, convex_solver
  opt_info:    trust-region / penalty solver overrides, log_results
  costs / constraints: [{type, name, params: {...}}] dispatched through a
               term-type registry (joint_{pos,vel,acc,jerk}, collision,
               cart_pose, dynamic_cart_pose, cart_vel, avoid_singularity,
               total_time, user_defined, plus registered types)
  init_info:   stationary | joint_interpolated | given_traj (+ dt)

Unknown document fields raise ``ValueError`` (``ensure_only_members``).
``manip`` selects nothing: the caller's :class:`Environment` carries the
kinematic tree and collision scene.  The problem solves on the device
given to :func:`construct_problem` (None: CUDA, raising when there is
none); ``JsonProblem.solve()`` solves the document's one init as a batch
of one lane, and ``jp.prob.make_solve(jp.sqp)(inits)`` solves a batch.

``convex_solver`` names: ``jax`` (the documents' name for the on-device
ADMM QP) and the reference's first-order ModelType names (AUTO_SOLVER,
OSQP, QPOASES) take the dense ADMM; ``ipm`` and the interior-point names
(BPMPD, GUROBI) the IPM QP; ``native`` the host reference driver with
the C++ QP (``sqp/reference_solver.py``, ``qp/native.py``), as one lane.
PyYAML is imported only to read a ``.yaml`` / ``.yml`` file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Callable

import numpy as np
import torch

from trajopt_tpu_torch import resolve_device
from trajopt_tpu_torch.collision.world import CollisionScene
from trajopt_tpu_torch.kinematics.chain import KinematicTree
from trajopt_tpu_torch.problem.trajectory import (
    TrajOptProblem, given_init, interpolated_init, stationary_init)
from trajopt_tpu_torch.sqp.params import SQPParams
from trajopt_tpu_torch.terms import cartesian as cart_terms
from trajopt_tpu_torch.terms import joint as joint_terms
from trajopt_tpu_torch.terms.collision import collision_term

# tesseract::collision::CollisionEvaluatorType int values of the documents
_EVALUATOR_MAP = {1: "discrete", 2: "lvs_discrete", 3: "cast", 4: "cast"}

# User-extensible term-type registry (TermInfo::RegisterMaker).  A builder
# receives (prob, env, params_dict, is_cost, name) and must prob.add_term.
TERM_REGISTRY: dict[str, Callable] = {}


def register_term_type(type_name: str):
    """Decorator: register a custom JSON term type (RegisterMaker)."""

    def deco(builder: Callable):
        TERM_REGISTRY[type_name] = builder
        return builder

    return deco


@dataclasses.dataclass
class Environment:
    """What the reference gets from tesseract: kinematics and collision."""

    tree: KinematicTree
    scene: CollisionScene | None = None
    current_state: np.ndarray | None = None


class JsonProblem:
    """A constructed document: the problem, its init trajectory
    ``[n_steps, n_dof_total]`` (float64, CPU), its SQP settings and its
    logging options."""

    def __init__(self, prob: TrajOptProblem, init_traj, sqp: SQPParams,
                 backend: str = "jax", log_results: bool = False,
                 log_dir: str | None = None):
        if backend not in ("jax", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        self.prob = prob
        self.init_traj = init_traj
        self.sqp = sqp
        self.backend = backend
        self.log_results = log_results
        self.log_dir = tempfile.gettempdir() if log_dir is None else log_dir

    def solve(self, params: Any = None):
        """Solve the document's init as one lane on the problem's device;
        returns the batch-of-one ``SQPResult``, or with ``backend ==
        "native"`` the host reference driver's ``RefResult`` (convexify on
        the problem's device, the C++ QP on the host; the reference's
        selectable-backend path, solver_interface.cpp:255-292).  With
        ``log_results`` the CSV logger runs as the per-iteration callback
        of the batched solver and writes ``trajopt_solver.log`` /
        ``trajopt_vars.log`` to ``log_dir``."""
        callback = logger = None
        if self.log_results:
            from trajopt_tpu_torch.callbacks import (CsvLogger,
                                                     make_iteration_callback)
            logger = CsvLogger()
            callback = make_iteration_callback(logger)
        if self.backend == "native":
            from trajopt_tpu_torch.sqp.reference_solver import \
                solve_reference
            x0 = torch.as_tensor(self.init_traj).reshape(1, -1)
            lb, ub = self.prob.bounds(x0)
            res = solve_reference(self.prob.build(), x0[0], lb[0], ub[0],
                                  params or {}, self.sqp,
                                  device=self.prob.device)
        else:
            params = {k: torch.as_tensor(v)[None] for k, v in
                      (params or {}).items()}
            res = self.prob.make_solve(self.sqp, callback=callback)(
                self.init_traj[None], params)
        if logger is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            logger.write_solver_log(os.path.join(self.log_dir,
                                                 "trajopt_solver.log"))
            logger.write_vars_log(os.path.join(self.log_dir,
                                               "trajopt_vars.log"))
        return res


def _ensure_only(d: dict, allowed: set[str], where: str):
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown fields {sorted(unknown)} in {where}")


def _broadcast(v, n, default=None):
    if v is None:
        v = default
    arr = np.asarray(v, float).reshape(-1)
    if arr.size == 1:
        arr = np.full(n, arr[0])
    if arr.size != n:
        raise ValueError(f"expected length {n}, got {arr.size}")
    return arr


def load_problem_file(path: str, env: Environment,
                      device=None) -> JsonProblem:
    """Load a problem document from .json or .yaml/.yml."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        doc = yaml.safe_load(text)
    else:
        doc = json.loads(text)
    return construct_problem(doc, env, device=device)


def construct_problem(doc: dict | str, env: Environment,
                      device=None) -> JsonProblem:
    """ConstructProblem(json, env): the document's problem, solving on
    ``device`` (None: CUDA, raising when there is none)."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    _ensure_only(doc, {"basic_info", "opt_info", "costs", "constraints",
                       "init_info", "param_info"}, "problem document")

    bi = doc["basic_info"]
    _ensure_only(bi, {"n_steps", "manip", "fixed_timesteps", "fixed_dofs",
                      "convex_solver", "dt_lower_lim", "dt_upper_lim",
                      "use_time", "start_fixed", "robot"}, "basic_info")
    n_steps = int(bi["n_steps"])
    use_time = bool(bi.get("use_time", False))
    prob = TrajOptProblem(
        n_steps=n_steps, n_dof=env.tree.n_dof,
        joint_lower=env.tree.lower, joint_upper=env.tree.upper,
        use_time=use_time,
        dt_lower=float(bi.get("dt_lower_lim", 1.0)),
        dt_upper=float(bi.get("dt_upper_lim", 1.0)),
        fixed_steps=list(bi.get("fixed_timesteps", [])),
        fixed_dofs=list(bi.get("fixed_dofs", [])),
        device=resolve_device(device))

    # The init trajectory comes first: collision terms derive their LVS
    # sub-step count from it (see _add_term).
    init_traj = _parse_init(doc.get("init_info", {"type": "stationary"}),
                            env, n_steps, use_time)

    for section, is_cost in (("costs", True), ("constraints", False)):
        for i, term_doc in enumerate(doc.get(section, [])):
            _add_term(prob, env, term_doc, is_cost, f"{section}[{i}]",
                      init_traj=init_traj)

    oi = doc.get("opt_info", {})
    sqp = _parse_opt_info(oi)
    from trajopt_tpu_torch.utils.config import env_qp_backend
    backend = str(bi.get("convex_solver", env_qp_backend())).lower()
    # The reference's ModelType names: first-order / default solvers take
    # the ADMM QP, interior-point ones (BPMPD, GUROBI) the IPM.
    backend = {"auto_solver": "jax", "osqp": "jax", "qpoases": "jax",
               "bpmpd": "ipm", "gurobi": "ipm"}.get(backend, backend)
    if backend not in ("jax", "native", "ipm"):
        raise ValueError(f"unknown convex_solver {backend!r} "
                         "(expected 'jax', 'native', 'ipm', or a reference "
                         "ModelType name: AUTO_SOLVER/OSQP/QPOASES/BPMPD/"
                         "GUROBI)")
    if backend == "ipm":
        sqp = dataclasses.replace(sqp, qp_algorithm="ipm")
        backend = "jax"
    return JsonProblem(prob, init_traj, sqp, backend=backend,
                       log_results=bool(oi.get("log_results", False)),
                       log_dir=oi.get("log_dir"))


def _add_term(prob: TrajOptProblem, env: Environment, doc: dict,
              is_cost: bool, where: str, init_traj=None):
    _ensure_only(doc, {"type", "name", "params", "term_type"}, where)
    ttype = doc["type"]
    params = dict(doc.get("params", {}))
    name = doc.get("name", ttype)
    n_dof = prob.n_dof
    n_steps = prob.n_steps
    kw_common = dict(n_dof_total=prob.n_dof_total, name=name)

    if ttype == "total_time":
        _ensure_only(params, {"coeff", "limit"}, where)
        from trajopt_tpu_torch.terms import time as time_terms
        prob.add_term(time_terms.total_time(
            n_steps, n_dof, is_cost=is_cost,
            coeff=float(params.get("coeff", 1.0)),
            limit=float(params.get("limit", 0.0)), name=name))
        return
    if ttype in ("joint_pos", "joint_vel", "joint_acc", "joint_jerk"):
        _ensure_only(params, {"coeffs", "targets", "upper_tols", "lower_tols",
                              "first_step", "last_step", "use_time"}, where)
        # basic_info.use_time switches velocity and acceleration terms to
        # their 1/dt-scaled variants (readCosts: term_type |= TT_USE_TIME)
        if prob.use_time and ttype in ("joint_vel", "joint_acc"):
            from trajopt_tpu_torch.terms import time as time_terms
            mk = (time_terms.joint_vel_time if ttype == "joint_vel"
                  else time_terms.joint_acc_time)
            kw = dict(is_cost=is_cost,
                      coeffs=_broadcast(params.get("coeffs"), n_dof, 1.0),
                      first_step=int(params.get("first_step", 0)),
                      last_step=int(params.get("last_step", -1)),
                      name=name)
            if ttype == "joint_vel":
                kw.update(
                    targets=_broadcast(params.get("targets"), n_dof, 0.0),
                    upper_tols=(_broadcast(params["upper_tols"], n_dof)
                                if "upper_tols" in params else None),
                    lower_tols=(_broadcast(params["lower_tols"], n_dof)
                                if "lower_tols" in params else None))
            prob.add_term(mk(n_steps, n_dof, **kw))
            return
        deriv = {"joint_pos": "pos", "joint_vel": "vel",
                 "joint_acc": "acc", "joint_jerk": "jerk"}[ttype]
        prob.add_term(joint_terms.joint_term(
            deriv, is_cost, n_steps, n_dof,
            targets=_broadcast(params.get("targets"), n_dof, 0.0),
            coeffs=_broadcast(params.get("coeffs"), n_dof, 1.0),
            upper_tols=_broadcast(params.get("upper_tols"), n_dof, 0.0),
            lower_tols=_broadcast(params.get("lower_tols"), n_dof, 0.0),
            first_step=int(params.get("first_step", 0)),
            last_step=int(params.get("last_step", -1)),
            **kw_common))
    elif ttype == "collision":
        _add_collision(prob, env, params, is_cost, where, name, init_traj)
    elif ttype == "user_defined":
        _ensure_only(params, {"error_function", "jacobian_function",
                              "penalty_type", "constraint_type", "coeffs",
                              "first_step", "last_step", "fixed_steps"},
                     where)
        from trajopt_tpu_torch.terms.user import (USER_FUNCTIONS,
                                                  user_defined_term)
        err_name = params["error_function"]
        if err_name not in USER_FUNCTIONS:
            raise ValueError(
                f"error_function {err_name!r} not registered "
                f"(register_user_function) in {where}")
        jac_name = params.get("jacobian_function")
        if jac_name is not None and jac_name not in USER_FUNCTIONS:
            raise ValueError(f"jacobian_function {jac_name!r} not "
                             f"registered in {where}")
        pen_names = {0: "squared", 1: "abs", 2: "hinge"}
        cnt_names = {0: "eq", 1: "ineq"}
        pen = params.get("penalty_type", "squared")
        cnt = params.get("constraint_type", "eq")
        prob.add_term(user_defined_term(
            USER_FUNCTIONS[err_name], n_steps, n_dof,
            jac_fn=USER_FUNCTIONS.get(jac_name),
            is_cost=is_cost,
            penalty_type=pen_names.get(pen, pen),
            constraint_type=cnt_names.get(cnt, cnt),
            coeffs=params.get("coeffs"),
            first_step=int(params.get("first_step", 0)),
            last_step=int(params.get("last_step", -1)),
            fixed_steps=list(params.get("fixed_steps", [])),
            **kw_common))
    elif ttype in ("cart_pose", "dynamic_cart_pose"):
        _add_cart_pose(prob, env, ttype, params, is_cost, where, name)
    elif ttype == "avoid_singularity":
        _ensure_only(params, {"link", "lambda", "coeffs", "first_step",
                              "last_step"}, where)
        prob.add_term(cart_terms.avoid_singularity(
            env.tree, params.get("link", env.tree.link_names[-1]),
            n_steps, lambda_=float(params.get("lambda", 1e-3)),
            coeff=float(np.asarray(params.get("coeffs", 1.0)).reshape(-1)[0]),
            first_step=int(params.get("first_step", 0)),
            last_step=int(params.get("last_step", -1)), **kw_common))
    elif ttype == "cart_vel":
        _ensure_only(params, {"first_step", "last_step", "max_displacement",
                              "link"}, where)
        prob.add_term(cart_terms.cart_vel(
            env.tree, params["link"], n_steps,
            max_displacement=float(params["max_displacement"]),
            first_step=int(params.get("first_step", 0)),
            last_step=int(params.get("last_step", -1)),
            is_cost=is_cost, **kw_common))
    elif ttype in TERM_REGISTRY:
        TERM_REGISTRY[ttype](prob, env, params, is_cost, name)
    else:
        raise ValueError(f"unknown term type {ttype!r} in {where}")


def _add_collision(prob, env, params, is_cost, where, name, init_traj):
    _ensure_only(params, {"coeffs", "dist_pen", "evaluator_type",
                          "first_step", "last_step", "fixed_steps",
                          "longest_valid_segment_length",
                          "safety_margin_buffer", "contact_test_type",
                          "use_weighted_sum", "pairs", "max_num_cnt"}, where)
    if env.scene is None:
        raise ValueError("collision term requires env.scene")
    n_dof, n_steps = prob.n_dof, prob.n_steps
    ev = _EVALUATOR_MAP[int(params.get("evaluator_type", 1))]
    # ContactTestType {FIRST=0, CLOSEST=1, ALL=2}: the static all-pairs
    # narrowphase is ALL; FIRST and CLOSEST would change which contacts
    # exist, so they are rejected.
    ctt = int(params.get("contact_test_type", 2))
    if ctt != 2:
        raise ValueError(
            f"contact_test_type={ctt} unsupported in {where}: the "
            f"static narrowphase evaluates ALL (=2) contacts")
    # coeffs / dist_pen: scalar or per-timestep vector
    dist_pen = np.asarray(params["dist_pen"], float).reshape(-1)
    coeff = np.asarray(params.get("coeffs", 20.0), float).reshape(-1)
    # per-link-pair overrides
    pair_coeffs: dict = {}
    pair_margins: dict = {}
    for j, ent in enumerate(params.get("pairs", [])):
        _ensure_only(ent, {"link", "pair", "coeffs", "dist_pen"},
                     f"{where}.pairs[{j}]")
        plist = list(ent["pair"])
        if not plist:
            raise ValueError(f"empty pair list in {where}.pairs[{j}]")
        for p in plist:
            if "coeffs" in ent:
                pair_coeffs[(ent["link"], p)] = float(ent["coeffs"])
            if "dist_pen" in ent:
                pair_margins[(ent["link"], p)] = float(ent["dist_pen"])
    # Static shapes need a fixed sub-step count: the init trajectory's
    # worst gap displacement over longest_valid_segment_length, in [2, 8]
    # (the JAX package's rule, which the reference's per-call subdivision
    # bounds in practice since the smoothing costs shrink per-gap motion).
    lvs_len = float(params.get("longest_valid_segment_length", 0.5))
    if init_traj is not None and n_steps > 1:
        tr = np.asarray(init_traj)[:, :n_dof]
        max_disp = float(np.max(np.linalg.norm(np.diff(tr, axis=0), axis=1)))
    elif init_traj is not None:
        max_disp = 0.0
    else:
        max_disp = 0.5
    lvs_substeps = max(2, min(8, int(np.ceil(max_disp
                                             / max(lvs_len, 1e-4)))))
    mnc = params.get("max_num_cnt")
    if mnc is None and env.scene.n_pairs > 64:
        # All-pairs rows make the QP quadratically large on reference-scale
        # scenes; the reference caps contacts too (max_num_cnt).  The JAX
        # package measured top-32 per step / sub-segment as the default.
        mnc = 32
    prob.add_term(collision_term(
        env.scene, n_steps,
        margin=dist_pen if dist_pen.size > 1 else float(dist_pen[0]),
        coeff=coeff if coeff.size > 1 else float(coeff[0]),
        is_cost=is_cost, evaluator=ev,
        first_step=int(params.get("first_step", 0)),
        last_step=int(params.get("last_step", -1)),
        fixed_steps=list(params.get("fixed_steps", [])),
        lvs_substeps=lvs_substeps,
        pair_coeffs=pair_coeffs or None,
        pair_margins=pair_margins or None,
        max_num_cnt=int(mnc) if mnc is not None else None,
        aggregate=("weighted_average"
                   if bool(params.get("use_weighted_sum", False))
                   else "none"),
        safety_margin_buffer=float(params.get("safety_margin_buffer", 0.0)),
        n_dof_total=prob.n_dof_total, name=name))


def _add_cart_pose(prob, env, ttype, params, is_cost, where, name):
    """cart_pose / dynamic_cart_pose: the same field set, both frame
    offsets applied; a target frame that moves with q makes the term
    dynamic."""
    _ensure_only(params, {"timestep", "source_frame", "target_frame",
                          "pos_coeffs", "rot_coeffs",
                          "source_frame_offset_xyz",
                          "source_frame_offset_wxyz",
                          "target_frame_offset_xyz",
                          "target_frame_offset_wxyz",
                          "xyz", "wxyz", "link"}, where)
    n_steps = prob.n_steps
    timestep = int(params.get("timestep", n_steps - 1))
    coeffs = np.concatenate([_broadcast(params.get("pos_coeffs"), 3, 1.0),
                             _broadcast(params.get("rot_coeffs"), 3, 1.0)])
    link = params.get("source_frame", params.get("link"))
    target_frame = params.get("target_frame")
    src_xyz = np.asarray(params.get("source_frame_offset_xyz", [0, 0, 0]),
                         float)
    src_R = _quat_to_matrix(np.asarray(
        params.get("source_frame_offset_wxyz", [1, 0, 0, 0]), float))
    xyz = np.asarray(params.get(
        "target_frame_offset_xyz", params.get("xyz", [0, 0, 0])), float)
    R = _quat_to_matrix(np.asarray(params.get(
        "target_frame_offset_wxyz", params.get("wxyz", [1, 0, 0, 0])), float))
    tree = env.tree
    target_moves = (target_frame is not None
                    and target_frame in tree.link_names
                    and bool(np.any(tree.ancestor[tree.link_id(target_frame)])))
    if ttype == "dynamic_cart_pose":
        # the reference requires a moving target frame here
        if target_frame is None:
            raise ValueError(f"dynamic_cart_pose requires target_frame "
                             f"in {where}")
        if target_frame not in tree.link_names:
            raise ValueError(f"unknown target_frame {target_frame!r} "
                             f"in {where}")
        if not target_moves:
            raise ValueError(
                f"dynamic_cart_pose target_frame {target_frame!r} is "
                f"static; use cart_pose in {where}")
    kw = dict(is_cost=is_cost, tcp=(src_R, src_xyz), coeffs=coeffs,
              n_dof_total=prob.n_dof_total, name=name)
    if target_moves:
        prob.add_term(cart_terms.dynamic_cart_pose(
            tree, link, target_frame, n_steps, timestep,
            target_tcp=(R, xyz), **kw))
    else:
        prob.add_term(cart_terms.cart_pose(
            tree, link, n_steps, timestep, target=(R, xyz), **kw))


def _parse_init(doc: dict, env: Environment, n_steps: int, use_time: bool):
    """The init trajectory [n_steps, n_dof (+1)] in float64 on the CPU."""
    _ensure_only(doc, {"type", "data", "endpoint", "dt"}, "init_info")
    t = doc.get("type", "stationary").lower()
    dt = float(doc.get("dt", 1.0)) if use_time else None
    n_dof = env.tree.n_dof
    cur = np.zeros(n_dof) if env.current_state is None \
        else np.asarray(env.current_state, float)
    cur = torch.as_tensor(cur, dtype=torch.float64)
    if t == "stationary":
        return stationary_init(cur, n_steps, dt)
    if t == "given_traj":
        data = np.asarray(doc["data"], float)
        if data.shape != (n_steps, n_dof):
            raise ValueError(f"given_traj data has shape {data.shape}, "
                             f"expected {(n_steps, n_dof)}")
        return given_init(torch.as_tensor(data), dt)
    if t == "joint_interpolated":
        end = torch.as_tensor(np.asarray(doc["endpoint"], float))
        return interpolated_init(cur, end, n_steps, dt)
    raise ValueError(f"unknown init_info type {t!r}")


def _parse_opt_info(doc: dict) -> SQPParams:
    allowed = {
        "improve_ratio_threshold", "min_trust_box_size", "min_approx_improve",
        "min_approx_improve_frac", "max_iter", "trust_shrink_ratio",
        "trust_expand_ratio", "cnt_tolerance", "max_merit_coeff_increases",
        "merit_coeff_increase_ratio", "initial_merit_error_coeff",
        "trust_box_size", "max_time", "log_results", "log_dir", "num_threads",
        "inflate_constraints_individually", "max_qp_solver_failures",
    }
    _ensure_only(doc, allowed, "opt_info")
    kw = {}
    for k in ("improve_ratio_threshold", "min_trust_box_size",
              "min_approx_improve", "min_approx_improve_frac",
              "trust_shrink_ratio", "trust_expand_ratio", "cnt_tolerance",
              "merit_coeff_increase_ratio", "initial_merit_error_coeff"):
        if k in doc:
            kw[k] = float(doc[k])
    for k in ("max_iter", "max_merit_coeff_increases",
              "max_qp_solver_failures"):
        if k in doc:
            kw[k] = int(doc[k])
    if "inflate_constraints_individually" in doc:
        kw["inflate_constraints_individually"] = bool(
            doc["inflate_constraints_individually"])
    if "trust_box_size" in doc:
        kw["initial_trust_box_size"] = float(doc["trust_box_size"])
    if "max_time" in doc:
        # kept in SQPParams; the port's solver, like the JAX make_solver,
        # has no wall clock (only the JAX package's reference solver reads
        # it)
        kw["max_time"] = float(doc["max_time"])
    if "num_threads" in doc and int(doc["num_threads"]) > 1:
        # term evaluation is batched on the device; parallelism is lanes
        raise ValueError(
            "opt_info.num_threads > 1 has no analog: term evaluation "
            "is batched on the device; batch problems for parallelism")
    return dataclasses.replace(SQPParams(), **kw)


def _quat_to_matrix(wxyz):
    w, x, y, z = [float(v) for v in wxyz]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
