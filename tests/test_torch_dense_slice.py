"""Port parity for the second slice as a whole: the arm7 discrete workload
through the dense QP path (``make_solve`` with its default
``structured=False``) against the JAX package on the CPU.

* the whole solve (arm7, 10 steps, 3 lanes, ``discrete_params()``) in
  float64 and in float32;
* the README's usage example, ported, on ``device="cpu"``;
* ``stationary_init``, the arm7 batch builder, the swept verification of
  arm7 solutions, and the carry-across of the arm7 scene and the
  discrete parameters (``interop.py``).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import benchmarks as jbench
from trajopt_tpu.problem.trajectory import interpolated_init as jax_interp
from trajopt_tpu.problem.trajectory import stationary_init as jax_stationary
from trajopt_tpu_torch import interop
from trajopt_tpu_torch.models import benchmarks as tbench
from trajopt_tpu_torch.models.robots import arm7, arm7_scene
from trajopt_tpu_torch.problem.trajectory import stationary_init
from trajopt_tpu_torch.qp import fused_dense as fd
from trajopt_tpu_torch.sqp.solver import make_solver

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_STEPS, LANES = 10, 3
# Seed 1: every float32 decision of this solve clears its threshold (the
# port's float32 counts are the same at any thread count and under 3e-6
# perturbations of the inits, and equal the float64 ones).  Near
# convergence the trust region compares model improvements of ~1e-4 with
# min_approx_improve = 1e-4, and with seed 0 one of them lands within
# float32 rounding of it: two float32 implementations then part ways.
SEED = 1


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params():
    """``__graft_entry__._solver_params("discrete")``, the JAX workload's
    settings, and the port's copy of them (``chip_smoke.discrete_params``)."""
    return (_load("__graft_entry__")._solver_params("discrete"),
            _load("chip_smoke").discrete_params())


def _inits_goals():
    goals = tbench.arm7_goals(SEED, LANES)
    w = np.linspace(0.0, 1.0, N_STEPS)[:, None]
    return tbench.ARM7_HOME * (1 - w) + goals[:, None, :] * w, goals


def _jax_solve(dtype):
    jparams, _ = _jax_params()
    prob, _ = jbench.arm_table_problem(n_steps=N_STEPS)
    solve = prob.make_solve(jparams)
    inits, goals = _inits_goals()
    res = jax.jit(jax.vmap(lambda i, g: solve(i, {"goal": g})))(
        jnp.asarray(inits, dtype), jnp.asarray(goals, dtype))
    return jax.tree.map(np.asarray, res)


def test_discrete_params_match_jax():
    jparams, tparams = _jax_params()
    assert dataclasses.asdict(tparams) == dataclasses.asdict(jparams)
    assert dataclasses.asdict(interop.sqp_params_from_dict(
        dataclasses.asdict(jparams))) == dataclasses.asdict(jparams)


def test_dense_solve_matches_jax():
    """float64: equal status and counts, x within 1e-6 (measured ~1e-14:
    the same float64 arithmetic with the products summed in another
    order)."""
    ref = _jax_solve(jnp.float64)
    _, params = _jax_params()
    prob, _ = tbench.arm_table_problem(n_steps=N_STEPS, device="cpu")
    inits, goals = _inits_goals()
    res = prob.make_solve(params)(inits, {"goal": goals})
    assert res.x.dtype == torch.float64
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_array_equal(res.n_func_evals.numpy(),
                                  ref.n_func_evals)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.cnt_viols.numpy(), ref.cnt_viols,
                               rtol=0, atol=1e-8)
    assert (res.status.numpy() == 1).all()


def test_float32_dense_solve_matches_jax_float32():
    """The card's precision on the CPU: the port in float32 (the dense
    chunk's plain version) against the JAX package in float32; equal
    counts and x within 1e-4 (two float32 solves summing in another order
    over ~8 SQP steps of 60-iteration QPs, on trajectories of magnitude
    ~1.5)."""
    with jax.enable_x64(False):
        ref = _jax_solve(jnp.float32)
    assert ref.x.dtype == np.float32
    _, params = _jax_params()
    prob, _ = tbench.arm_table_problem(n_steps=N_STEPS, device="cpu")
    solve = make_solver(prob.build(), params)
    inits, goals = _inits_goals()
    x0 = torch.as_tensor(inits.reshape(LANES, -1), dtype=torch.float32)
    res = solve(x0, *prob.bounds(x0),
                {"goal": torch.as_tensor(goals, dtype=torch.float32)})
    assert res.x.dtype == torch.float32
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
    np.testing.assert_array_equal(res.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(res.n_qp_solves.numpy(), ref.n_qp_solves)
    np.testing.assert_allclose(res.x.numpy(), ref.x, rtol=0, atol=1e-4)
    assert (res.status.numpy() == 1).all()


def test_readme_usage_runs_on_cpu():
    """The README's usage example with the port's modules on the CPU (the
    default dense path and default parameters): one problem, then a batch,
    against the same example in JAX (float64: equal status and counts, x
    within 1e-6)."""
    from trajopt_tpu.models import robots as jrobots
    from trajopt_tpu.problem.trajectory import TrajOptProblem as JaxProblem
    from trajopt_tpu.terms.collision import collision_term as jcollision
    from trajopt_tpu.terms.joint import joint_pos as jpos
    from trajopt_tpu.terms.joint import joint_vel as jvel
    from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
    from trajopt_tpu_torch.terms.collision import collision_term
    from trajopt_tpu_torch.terms.joint import joint_pos, joint_vel

    tree, scene = arm7(), arm7_scene()
    n = 30
    prob = TrajOptProblem(n_steps=n, n_dof=7, joint_lower=tree.lower,
                          joint_upper=tree.upper, fixed_steps=[0],
                          device="cpu")
    prob.add_term(joint_vel(n, 7, is_cost=True, coeffs=np.full(7, 5.0)))
    prob.add_term(joint_pos(n, 7, is_cost=False, targets="goal",
                            first_step=n - 1, last_step=n - 1))
    prob.add_term(collision_term(scene, n, margin=0.025, coeff=20.0,
                                 is_cost=False, fixed_steps=[0]))
    solve = prob.make_solve()
    before = fd.COUNTER.launches
    # one problem
    res = solve(stationary_init(torch.zeros(1, 7), n),
                {"goal": torch.ones(1, 7)})
    # a batch of problems
    goals = torch.ones(2, 7)
    goals[1, 0] = 0.8
    batch = solve(stationary_init(torch.zeros(2, 7), n), {"goal": goals})
    assert fd.COUNTER.launches == before      # the CPU runs the plain version

    jprob = JaxProblem(n_steps=n, n_dof=7, joint_lower=tree.lower,
                       joint_upper=tree.upper, fixed_steps=[0])
    jprob.add_term(jvel(n, 7, is_cost=True, coeffs=np.full(7, 5.0)))
    jprob.add_term(jpos(n, 7, is_cost=False, targets="goal",
                        first_step=n - 1, last_step=n - 1))
    jprob.add_term(jcollision(jrobots.arm7_scene(), n, margin=0.025,
                              coeff=20.0, is_cost=False, fixed_steps=[0]))
    ref = jax.tree.map(np.asarray, jax.jit(jprob.make_solve())(
        jax_stationary(jnp.zeros(7), n), {"goal": jnp.ones(7)}))
    for r in (res, batch):
        assert int(r.status[0]) == int(ref.status) == 1
        assert int(r.n_iter[0]) == int(ref.n_iter)
        assert int(r.n_qp_solves[0]) == int(ref.n_qp_solves)
        np.testing.assert_allclose(r.x[0].numpy(), ref.x, rtol=0, atol=1e-6)
    assert (batch.status == 1).all()


def test_stationary_init_matches_jax():
    q = np.random.default_rng(0).standard_normal((2, 7))
    for dt in (None, 0.1):
        ref = jax.vmap(lambda v: jax_stationary(v, 5, dt))(jnp.asarray(q))
        got = stationary_init(torch.as_tensor(q), 5, dt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_arm7_batch_builder():
    inits, goals = tbench.arm_table_batch(SEED, 6, N_STEPS, device="cpu")
    tree = arm7()
    g = goals.numpy()
    assert ((g >= tree.lower + 0.05 - 1e-12)
            & (g <= tree.upper - 0.05 + 1e-12)).all()
    ref = jax.vmap(lambda gg: jax_interp(jnp.asarray(tbench.ARM7_HOME), gg,
                                         N_STEPS))(jnp.asarray(g))
    np.testing.assert_allclose(inits.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(tbench.ARM7_HOME, jbench.ARM7_HOME)
    np.testing.assert_array_equal(tbench.ARM7_GOAL, jbench.ARM7_GOAL)


def test_arm7_swept_verify_and_interop_match_jax():
    """The port's swept check of arm7 trajectories (capsule-box and
    sphere-box pairs) against the JAX swept query per gap and
    sub-segment, on the carried-across scene and on the port's own."""
    _, jscene = jbench.arm_table_problem(n_steps=N_STEPS)
    carried = interop.scene_from_numpy(interop.scene_to_numpy(jscene))
    own = arm7_scene()
    assert [(a.name, b.name) for a, b in carried.pairs()] == \
        [(a.name, b.name) for a, b in own.pairs()]
    inits, goals = _inits_goals()
    traj = inits + 0.02 * np.random.default_rng(3).standard_normal(
        inits.shape)
    max_disp = np.max(np.linalg.norm(np.diff(traj, axis=1), axis=2))
    fr = np.linspace(0.0, 1.0, max(1, int(np.ceil(max_disp / 0.05))) + 1)

    def lane_min(tr):
        def gap_min(a, b):
            d = jax.vmap(lambda f0, f1: jscene.swept_distances(
                a + f0 * (b - a), a + f1 * (b - a)))(fr[:-1], fr[1:])
            return jnp.min(d)
        return jnp.min(jax.vmap(gap_min)(tr[:-1], tr[1:]))

    ref = np.asarray(jax.jit(jax.vmap(lane_min))(jnp.asarray(traj)))
    assert (ref < 0).any()                    # the line crosses the post
    for scene in (carried, own):
        got = tbench.swept_verify(scene, torch.tensor(traj))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


def test_arm7_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.arm_table_problem(n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.arm_table_batch(0, 2, 4)
    prob, _ = tbench.arm_table_problem(n_steps=4, device="cpu")
    inits, goals = tbench.arm_table_batch(0, 2, 4, device="cpu")
    assert inits.dtype == torch.float64 and inits.device.type == "cpu"
    res = prob.make_solve()(inits, {"goal": goals})
    assert res.x.shape == (2, 28) and res.x.dtype == torch.float64


def test_dense_path_options_that_wait_raise():
    """The IPM runs on the dense path only (a ValueError elsewhere, as in
    JAX).  The lvs_discrete evaluator is ported: it builds, one row per
    (gap, sub-point, pair); an evaluator the port does not have raises,
    naming the ones it has."""
    prob, _ = tbench.arm_table_problem(n_steps=4, device="cpu")
    _, params = _jax_params()
    ipm = dataclasses.replace(params, qp_algorithm="ipm")
    make_solver(prob.build(), ipm)
    with pytest.raises(ValueError, match="dense path"):
        make_solver(prob.build(), ipm, structured=True)
    lvs, _ = tbench.arm_table_problem(n_steps=4, evaluator="lvs_discrete",
                                      device="cpu")
    assert lvs.build().term_sets[2].n_rows == 3 * 4 * 8
    with pytest.raises(ValueError, match="lvs_discrete"):
        tbench.arm_table_problem(n_steps=4, evaluator="continuous",
                                 device="cpu")
