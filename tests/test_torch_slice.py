"""Port parity for the slice as a whole: the pr2ish cast problem of
``trajopt_tpu_torch`` against the JAX package, float64 on the CPU.

* every ``StructuredModel`` field of ``convexify_structured`` at one x;
* the whole flagship-settings solve of a 10-step problem on 3 lanes, and
  the same solve in float32 against JAX in float32;
* the swept verification and the batch builder;
* the carry-across of scene, tree and parameters (``interop.py``);
* the device policy (no quiet CPU fallback) and the import boundary (the
  port never loads ``jax`` or ``trajopt_tpu``).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu_torch
from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.problem.trajectory import TrajOptProblem as JaxTrajOptProblem
from trajopt_tpu.problem.trajectory import interpolated_init as jax_interp
from trajopt_tpu.qp.admm import ADMMConfig as JaxADMMConfig
from trajopt_tpu.sqp import nlp as jnlp
from trajopt_tpu.sqp.params import SQPParams as JaxSQPParams
from trajopt_tpu.terms import joint as jjoint
from trajopt_tpu_torch import interop
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models.robots import pr2ish, pr2ish_scene
from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
from trajopt_tpu_torch.sqp import nlp as tnlp
from trajopt_tpu_torch.sqp.solver import make_solver
from trajopt_tpu_torch.terms import joint as tjoint

torch.set_num_threads(2)

N_STEPS, LANES = 10, 3
REPO = Path(__file__).resolve().parents[1]

# __graft_entry__._solver_params("cast"): the flagship's SQP/QP settings
JAX_PARAMS = dataclasses.replace(
    JaxSQPParams(), max_restarts=1,
    qp=JaxADMMConfig(eps_abs=2e-5, eps_rel=2e-5, max_iter=450,
                     check_every=150, adaptive_rho=False, rho_dual_scale=0.1,
                     ruiz_iters=10, ns_refresh=True, ns_tol=1e-4,
                     ns_power_iters=4))


def _inits_goals():
    goals = tbench.pr2ish_goals(0, LANES)
    w = np.linspace(0.0, 1.0, N_STEPS)[:, None]
    inits = tbench.PR2ISH_HOME * (1 - w) + goals[:, None, :] * w
    return inits, goals


@pytest.fixture(scope="module")
def jax_solution():
    prob, _ = jbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2)
    solve = prob.make_solve(JAX_PARAMS, structured=True)
    inits, goals = _inits_goals()
    res = jax.jit(jax.vmap(lambda i, g: solve(i, {"goal": g})))(
        jnp.asarray(inits), jnp.asarray(goals))
    return jax.tree.map(np.asarray, res)


def test_convexify_structured_matches_jax():
    jprob, _ = jbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2)
    jn = jprob.build()
    tprob, _ = tbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2,
                                           device="cpu")
    tn = tprob.build()
    inits, goals = _inits_goals()
    rng = np.random.default_rng(7)
    x = inits.reshape(LANES, -1) + 0.03 * rng.standard_normal(
        (LANES, tn.n))

    def jax_model(x1, g):
        p = {"goal": g}
        return jnlp.convexify_structured(
            jn, x1, p, jnlp.linear_jacobians(jn, jn.n, p, x1.dtype))

    sm_j = jax.jit(jax.vmap(jax_model))(jnp.asarray(x), jnp.asarray(goals))
    xt, p = torch.as_tensor(x), {"goal": torch.as_tensor(goals)}
    sm_t = tnlp.convexify_structured(tn, xt, p,
                                     tnlp.linear_jacobians(tn, xt, p))
    for name in sm_t._fields:
        a, b = getattr(sm_t, name).numpy(), np.asarray(getattr(sm_j, name))
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-9,
                                   err_msg=name)


def test_solve_matches_jax(jax_solution):
    prob, _ = tbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2,
                                          device="cpu")
    params = interop.sqp_params_from_dict(dataclasses.asdict(JAX_PARAMS))
    solve = prob.make_solve(params, structured=True)
    inits, goals = _inits_goals()
    res = solve(inits, {"goal": goals})
    ref = jax_solution
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_array_equal(res.n_func_evals.numpy(),
                                  ref.n_func_evals)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.cnt_viols.numpy(), ref.cnt_viols,
                               rtol=0, atol=1e-8)
    assert (res.status.numpy() == 1).all()


def test_float32_solve_matches_jax_float32():
    """The card's precision on the CPU: the port in float32 (the chunk's
    plain version) against the JAX package in float32.  Both stop a step
    earlier than in float64 (the second step's QP does not reach eps in
    float32, its model merit rises, and the step ends as converged), so
    the counts are held equal and x within 1e-4: two float32 solves
    summing in another order over 2 SQP steps and up to 900 ADMM
    iterations, against trajectories of magnitude ~2."""
    inits, goals = _inits_goals()
    with jax.enable_x64(False):
        jprob, _ = jbench.pr2ish_table_problem(n_steps=N_STEPS,
                                               lvs_substeps=2)
        jsolve = jprob.make_solve(JAX_PARAMS, structured=True)
        ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(
            lambda i, g: jsolve(i, {"goal": g})))(
                jnp.asarray(inits, jnp.float32),
                jnp.asarray(goals, jnp.float32)))
    assert ref.x.dtype == np.float32
    prob, _ = tbench.pr2ish_table_problem(n_steps=N_STEPS, lvs_substeps=2,
                                          device="cpu")
    params = interop.sqp_params_from_dict(dataclasses.asdict(JAX_PARAMS))
    solve = make_solver(prob.build(), params, structured=True)
    x0 = torch.as_tensor(inits.reshape(LANES, -1), dtype=torch.float32)
    res = solve(x0, *prob.bounds(x0),
                {"goal": torch.as_tensor(goals, dtype=torch.float32)})
    assert res.x.dtype == torch.float32
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-4)
    assert (res.status.numpy() == 1).all()


def test_swept_verify_matches_jax(jax_solution):
    """The port's swept check against bench.py's (JAX, per gap and
    sub-segment) on the solved trajectories."""
    _, jscene = jbench.pr2ish_table_problem(n_steps=N_STEPS)
    traj = jax_solution.x.reshape(LANES, N_STEPS, 8)
    max_disp = np.max(np.linalg.norm(np.diff(traj, axis=1), axis=2))
    fr = np.linspace(0.0, 1.0, max(1, int(np.ceil(max_disp / 0.05))) + 1)

    def lane_min(tr):
        def gap_min(a, b):
            d = jax.vmap(lambda f0, f1: jscene.swept_distances(
                a + f0 * (b - a), a + f1 * (b - a)))(fr[:-1], fr[1:])
            return jnp.min(d)
        return jnp.min(jax.vmap(gap_min)(tr[:-1], tr[1:]))

    ref = np.asarray(jax.jit(jax.vmap(lane_min))(jnp.asarray(traj)))
    got = tbench.swept_verify(pr2ish_scene(), torch.tensor(traj))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)
    assert (ref > 0).all()


def test_batch_builder():
    inits, goals = tbench.pr2ish_table_batch(4, 6, N_STEPS, device="cpu")
    tree = pr2ish()
    g = goals.numpy()
    assert ((g >= tree.lower + 0.02 - 1e-12)
            & (g <= tree.upper - 0.02 + 1e-12)).all()
    ref = jax.vmap(lambda gg: jax_interp(jnp.asarray(tbench.PR2ISH_HOME),
                                         gg, N_STEPS))(jnp.asarray(g))
    np.testing.assert_allclose(inits.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-15)
    again, _ = tbench.pr2ish_table_batch(4, 6, N_STEPS, device="cpu")
    assert torch.equal(inits, again)


@pytest.mark.parametrize("deriv,is_cost,tols", [
    ("pos", False, None), ("vel", True, None), ("acc", True, 0.1),
    ("jerk", False, 0.05), ("vel", False, "key")])
def test_joint_terms_match_jax(deriv, is_cost, tols):
    """Every joint-term form: squared cost, equality, hinge band and
    inequality band, with params-key targets and tolerances."""
    n_steps, n_dof, lanes = 7, 3, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((lanes, n_steps * n_dof))
    params = {"goal": rng.standard_normal((lanes, n_dof)),
              "up": rng.uniform(0, 0.2, (lanes, n_dof)),
              "lo": -rng.uniform(0, 0.2, (lanes, n_dof))}
    kw = dict(targets="goal", coeffs=rng.uniform(0.5, 2, n_dof),
              first_step=1)
    if tols == "key":
        kw.update(upper_tols="up", lower_tols="lo")
    elif tols is not None:
        kw.update(upper_tols=np.full(n_dof, tols),
                  lower_tols=np.full(n_dof, -tols))
    jt = jjoint.joint_term(deriv, is_cost, n_steps, n_dof, **kw)
    tt = tjoint.joint_term(deriv, is_cost, n_steps, n_dof, **kw)
    assert (tt.kind.value, tt.n_rows, tt.band_width) == \
        (jt.kind.value, jt.n_rows, jt.band_width)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(
        tt.fn(xt, tp).numpy(),
        np.asarray(jax.vmap(jt.fn)(jnp.asarray(x), jp)), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        tnlp._weights(tt, tp, xt).numpy(),
        np.broadcast_to(np.asarray(jax.vmap(jt.weight_fn)(jp)).reshape(
            lanes, -1), (lanes, jt.n_rows)), rtol=0, atol=1e-14)
    if jt.banded_jac is not None:
        np.testing.assert_array_equal(tt.band_starts, jt.band_starts)
        np.testing.assert_allclose(
            tt.banded_jac(xt, tp).numpy(),
            np.asarray(jax.vmap(jt.banded_jac)(jnp.asarray(x), jp)),
            rtol=0, atol=1e-14)


@pytest.mark.parametrize("use_time", [False, True])
def test_bounds_match_jax(use_time):
    kw = dict(n_steps=5, n_dof=3, joint_lower=[-1.0, -2.0, -3.0],
              joint_upper=[1.0, 2.0, 3.0], use_time=use_time,
              fixed_steps=[0, 4], fixed_dofs=[1])
    jp, tp = JaxTrajOptProblem(**kw), TrajOptProblem(**kw)
    x = np.random.default_rng(6).standard_normal((2, tp.n))
    lb_j, ub_j = jax.vmap(jp.bounds)(jnp.asarray(x))
    lb_t, ub_t = tp.bounds(torch.as_tensor(x))
    np.testing.assert_array_equal(lb_t.numpy(), np.asarray(lb_j))
    np.testing.assert_array_equal(ub_t.numpy(), np.asarray(ub_j))


def test_interop_carries_the_problem():
    _, jscene = jbench.pr2ish_table_problem(n_steps=N_STEPS)
    carried = interop.scene_from_numpy(interop.scene_to_numpy(jscene))
    own = pr2ish_scene()
    assert [(a.name, b.name) for a, b in carried.pairs()] == \
        [(a.name, b.name) for a, b in own.pairs()]
    rng = np.random.default_rng(11)
    tree = own.tree
    q0 = torch.as_tensor(rng.uniform(tree.lower, tree.upper, (6, 8)))
    q1 = q0 + 0.1 * torch.as_tensor(rng.standard_normal((6, 8)))
    for a, b in zip(carried.tree.fk_with_axes(q0), tree.fk_with_axes(q0)):
        assert torch.equal(a, b)
    d_c = carried.swept_distances_and_jac(carried.tree.fk_with_axes(q0),
                                          carried.tree.fk_with_axes(q1))
    d_o = own.swept_distances_and_jac(tree.fk_with_axes(q0),
                                      tree.fk_with_axes(q1))
    for a, b in zip(d_c, d_o):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(carried.tree.lower, tree.lower)
    np.testing.assert_array_equal(carried.tree.ancestor, tree.ancestor)

    params = interop.sqp_params_from_dict(dataclasses.asdict(JAX_PARAMS))
    assert dataclasses.asdict(params) == dataclasses.asdict(JAX_PARAMS)
    with pytest.raises(TypeError):
        interop.sqp_params_from_dict({"no_such_field": 1})


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trajopt_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.pr2ish_table_problem(n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.pr2ish_table_batch(0, 2, 4)
    tree = pr2ish()
    bare = TrajOptProblem(n_steps=4, n_dof=8, joint_lower=tree.lower,
                          joint_upper=tree.upper)
    prob, _ = tbench.pr2ish_table_problem(n_steps=4, lvs_substeps=1,
                                          device="cpu")
    bare.term_sets = list(prob.term_sets)
    with pytest.raises(RuntimeError, match="CUDA"):
        bare.make_solve(structured=True)
    solve = bare.make_solve(structured=True, device="cpu")
    inits, goals = tbench.pr2ish_table_batch(0, 2, 4, device="cpu")
    assert inits.dtype == torch.float64 and inits.device.type == "cpu"
    res = solve(inits, {"goal": goals})
    assert res.x.shape == (2, 32) and res.x.dtype == torch.float64
    with pytest.raises(RuntimeError, match="CUDA"):
        bare.make_solve()                    # the dense path, too
    res = bare.make_solve(device="cpu")(inits, {"goal": goals})
    assert res.x.shape == (2, 32) and res.x.dtype == torch.float64


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import trajopt_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'trajopt_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 29, mods\n"
        "new = {'callbacks', 'qp.ipm', 'qp.banded', 'qp.admm_structured',\n"
        "       'problem.json_io', 'problem.mpc', 'collision.check',\n"
        "       'terms.cartesian', 'terms.time', 'terms.user',\n"
        "       'kinematics.ik', 'utils.config', 'plotting',\n"
        "       'collision.convex', 'collision.sdf_grid',\n"
        "       'collision.decompose', 'kinematics.srdf', 'ifopt',\n"
        "       'ifopt.constraints', 'ifopt.collision', 'qp.native',\n"
        "       'sqp.reference_solver', 'parallel', 'parallel.mesh',\n"
        "       'utils.cache', 'utils.checkpoint', 'utils.debug',\n"
        "       'utils.finite_diff', 'utils.joints', 'utils.logging',\n"
        "       'utils.profiling', 'utils.aot_cache'}\n"
        "assert {'trajopt_tpu_torch.' + m for m in new} <= set(mods), mods\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'trajopt_tpu' or "
        "k.startswith('trajopt_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_solver_imports_leave_matplotlib_and_yaml_out():
    """The JSON front end and the solver import neither of their optional
    dependencies: matplotlib (plots) and PyYAML (.yaml documents) load
    only when a plot is drawn or a YAML file read."""
    code = (
        "import sys\n"
        "import trajopt_tpu_torch.problem.json_io\n"
        "import trajopt_tpu_torch.sqp.solver\n"
        "import trajopt_tpu_torch.callbacks\n"
        "import trajopt_tpu_torch.plotting\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('matplotlib', 'yaml'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
